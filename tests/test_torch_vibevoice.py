"""VibeVoice in the PyTorch port against the JAX package, on the CPU at
float32: the DPM-Solver++ tables and sampler, the diffusion head, the
causal VAE decoder, `generate` (with and without a voice cache, the EOS
stop, `_generate_multi`), `sanitize`, `load_model` and `post_load_hook`.

Config: tests/test_vibevoice.py::_cfg (a 2-layer Qwen2 split 1 + 1 at d16,
a 1-layer head, a 3-stage VAE of hop 4), the JAX model's random
parameters bound into the port by `model.load_jax_params`. Sampled runs
feed the port JAX's own draws through `Model._draws`: JAX splits its key
once per latent (vibevoice.py:364-366), and the replay does the same.

Tolerances: 2e-4 absolute on the head, sampler, tables and hidden states
(summation order only); audio 2e-3 absolute (JAX's own bound between its
two KugelAudio paths, tests/test_kugelaudio.py:235-236). Sample counts must
be equal.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_tts_fixtures import vibevoice_hf_state, write_tts_checkpoint  # noqa: E402

from test_vibevoice import _cfg, _FakeTok  # noqa: E402

ATOL = 2e-4
AUDIO_ATOL = 2e-3


def _np(t):
    return t.detach().float().cpu().numpy()


_JAX = {}


def _jax_model():
    """(JAX model, flat numpy params), built once for the module."""
    if "m" not in _JAX:
        from mlx_audio_tpu.tts.models.vibevoice import Model
        from mlx_audio_tpu.utils import flatten

        jm = Model(_cfg())
        # one compiled init: the same numbers as the eager init_and_bind,
        # in about half its time on a cold compilation cache
        jm.bind(jax.jit(jm.init_params)(jax.random.PRNGKey(0)))
        jm.tokenizer = _FakeTok()
        _JAX["m"] = (jm, {k: np.asarray(v)
                          for k, v in flatten(jm.params).items()})
    return _JAX["m"]


def _port(flat=None):
    from mlx_audio_tpu_torch.model import load_jax_params
    from mlx_audio_tpu_torch.tts.models.vibevoice import Model

    jm, jflat = _jax_model()
    pm = load_jax_params(Model(dataclasses.asdict(jm.config), device="cpu"),
                         jflat if flat is None else flat)
    pm.tokenizer = _FakeTok()
    return pm


def _eos_biased(bias: float):
    """(JAX model, port model) with the EOS classifier's output bias set:
    -50 keeps EOS off (every window runs whole), +50 stops at the first
    latent."""
    from mlx_audio_tpu.tts.models.vibevoice import Model
    from mlx_audio_tpu.utils import unflatten

    jm, flat = _jax_model()
    flat = dict(flat)
    flat["tts_eos_classifier.fc2.bias"] = np.full((1,), bias, np.float32)
    jb = Model(jm.config)
    jb.bind(unflatten({k: jnp.asarray(v) for k, v in flat.items()}))
    jb.tokenizer = _FakeTok()
    return jb, _feed_jax_draws(_port(flat))


_DRAWS = {}


def _jax_draws(seed: int, n: int, latent: int) -> np.ndarray:
    """The noise of JAX's first n speech steps at `seed`: one split of the
    key and one (1, latent) normal a step. -> (n, 1, latent)."""
    have = _DRAWS.get((seed, latent), np.zeros((0, 1, latent), np.float32))
    if len(have) < n:
        rng = jax.random.PRNGKey(seed)
        out = []
        for _ in range(n):
            rng, sub = jax.random.split(rng)
            out.append(np.asarray(jax.random.normal(sub, (1, latent),
                                                    jnp.float32)))
        have = _DRAWS[(seed, latent)] = np.stack(out)
    return have[:n]


def _feed_jax_draws(pm):
    """Make the port draw JAX's noise, keyed by its generator's seed."""

    def draws(generator, start, n, shape):
        table = _jax_draws(generator.initial_seed(), start + n, shape[-1])
        return torch.from_numpy(table[start:start + n].reshape(
            (n,) + tuple(shape)))

    pm._draws = draws
    return pm


# ---------------------------------------------------------------------------
# scheduler, head, sampler, VAE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,n_train,n_inf", [
    ("dpm_tables", 50, 4), ("dpm_tables", 1000, 20),
    ("sde_dpm_tables", 1000, 10), ("sde_dpm_tables", 1000, 4)])
def test_scheduler_tables_equal_jax(name, n_train, n_inf):
    from mlx_audio_tpu.tts.models.vibevoice import scheduler as jsched
    from mlx_audio_tpu_torch.tts.models.vibevoice import scheduler

    want = getattr(jsched, name)(n_train, n_inf)
    got = getattr(scheduler, name)(n_train, n_inf)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_head_forward_matches_jax():
    from mlx_audio_tpu.tts.models.vibevoice.vibevoice import \
        head_forward as jhead
    from mlx_audio_tpu_torch.tts.models.vibevoice.vibevoice import \
        head_forward

    jm, _ = _jax_model()
    pm = _port()
    rs = np.random.RandomState(0)
    x = rs.randn(3, 8).astype(np.float32)
    t = np.array([999.0, 500.0, 3.0], np.float32)
    cond = rs.randn(3, 16).astype(np.float32)
    want = jhead(jm.params["prediction_head"], jm.config.diffusion_head_config,
                 jnp.asarray(x), jnp.asarray(t), jnp.asarray(cond))
    got = head_forward(pm.prediction_head, torch.from_numpy(x),
                       torch.from_numpy(t), torch.from_numpy(cond))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("cfg_scale", [1.5, 3.0])
def test_diffusion_sample_matches_jax(cfg_scale):
    from mlx_audio_tpu.tts.models.vibevoice.scheduler import \
        dpm_tables as jtables
    from mlx_audio_tpu.tts.models.vibevoice.vibevoice import \
        diffusion_sample as jsample
    from mlx_audio_tpu_torch.tts.models.vibevoice.scheduler import dpm_tables
    from mlx_audio_tpu_torch.tts.models.vibevoice.vibevoice import \
        diffusion_sample

    jm, _ = _jax_model()
    pm = _port()
    rs = np.random.RandomState(1)
    cond, neg = (rs.randn(1, 16).astype(np.float32) for _ in range(2))
    noise = rs.randn(1, 8).astype(np.float32)
    jt = {k: jnp.asarray(v) for k, v in jtables(50, 4).items()}
    want = jsample(jm.params["prediction_head"],
                   jm.config.diffusion_head_config, jnp.asarray(cond),
                   jnp.asarray(neg), jnp.asarray(noise), jt,
                   jnp.float32(cfg_scale))
    got = diffusion_sample(pm.prediction_head, torch.from_numpy(cond),
                           torch.from_numpy(neg), torch.from_numpy(noise),
                           dpm_tables(50, 4), cfg_scale)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)


def test_decode_latents_and_bucket_prefix_match_jax():
    """The causal decoder on 6 latents, and on them zero-padded to the
    16-bucket: the padded decode's prefix is the tight one."""
    from mlx_audio_tpu.tts.models.vibevoice.vibevoice import \
        decode_latents as jdecode
    from mlx_audio_tpu_torch.tts.models.vibevoice.vibevoice import \
        decode_latents

    jm, _ = _jax_model()
    pm = _port()
    a = jm.config.acoustic_tokenizer_config
    lat = np.random.RandomState(2).randn(1, 6, 8).astype(np.float32)
    padded = np.zeros((1, 16, 8), np.float32)
    padded[:, :6] = lat
    dec = pm.acoustic_tokenizer.decoder
    tight = decode_latents(dec, torch.from_numpy(lat))
    buck = decode_latents(dec, torch.from_numpy(padded))
    assert tight.shape == (1, 6 * a.hop_length)
    want = jdecode(jm.params["acoustic_tokenizer"], a, jnp.asarray(lat))
    np.testing.assert_allclose(_np(tight), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(_np(buck[:, :6 * a.hop_length]), _np(tight),
                               atol=1e-6)


# ---------------------------------------------------------------------------
# generate
# ---------------------------------------------------------------------------


def _save_voice(path, pos_len=3, neg_len=3, seed=2):
    """A voice cache for _cfg (1 LM layer, 1 TTS layer, 2 kv heads of 8),
    K/V stored (B, kv heads, S, head dim) as published."""
    from safetensors.numpy import save_file

    rs = np.random.RandomState(seed)
    t = {"lm_hidden": rs.randn(1, 3, 16).astype(np.float32),
         "tts_lm_hidden": rs.randn(1, pos_len, 16).astype(np.float32),
         "neg_tts_lm_hidden": rs.randn(1, neg_len, 16).astype(np.float32),
         "lm_key_0": rs.randn(1, 2, 3, 8).astype(np.float32),
         "lm_value_0": rs.randn(1, 2, 3, 8).astype(np.float32)}
    for pref, n in (("tts_lm", pos_len), ("neg_tts_lm", neg_len)):
        t[f"{pref}_key_0"] = rs.randn(1, 2, n, 8).astype(np.float32)
        t[f"{pref}_value_0"] = rs.randn(1, 2, n, 8).astype(np.float32)
    save_file(t, str(path))
    return str(path)


def _assert_same(got, want):
    assert got.samples == want.samples > 0
    assert got.token_count == want.token_count
    np.testing.assert_allclose(got.audio, np.asarray(want.audio),
                               atol=AUDIO_ATOL, rtol=0)


@pytest.mark.parametrize("voice", [False, True])
def test_sampled_generate_matches_jax(tmp_path, voice):
    """EOS off: eight latents over two speech windows (6 + 2) and two text
    windows, fed JAX's draws; with a voice cache the caches and conditions
    start from it."""
    jm, pm = _eos_biased(-50.0)
    vp = _save_voice(tmp_path / "alice.safetensors") if voice else None
    kw = dict(max_tokens=8, seed=3, voice=vp)
    want = next(jm.generate("hello world from the tpu", **kw))
    got = next(pm.generate("hello world from the tpu", **kw))
    _assert_same(got, want)
    assert got.samples == 8 * 4 and pm.last_run == {"windows": 2,
                                                     "latents": 8}


@pytest.mark.parametrize("bias", [None, 50.0])
def test_eos_stop_matches_jax(bias):
    """EOS at the first latent (the random weights' own classifier, and
    one biased on): the rest of the window runs on the device and is
    dropped."""
    if bias is None:
        jm, _ = _jax_model()
        pm = _feed_jax_draws(_port())
    else:
        jm, pm = _eos_biased(bias)
    kw = dict(max_tokens=8, seed=3)
    want = next(jm.generate("hello world from the tpu", **kw))
    got = next(pm.generate("hello world from the tpu", **kw))
    _assert_same(got, want)
    assert got.samples == 4 and pm.last_run == {"windows": 1, "latents": 1}


def test_generate_multi_matches_jax(tmp_path):
    """A two-speaker dialogue with EOS off: one voice each, seeds seed +
    index, audio joined; the result reports audio / elapsed (xRT)."""
    jm, pm = _eos_biased(-50.0)
    voices = [_save_voice(tmp_path / "a.safetensors", seed=4),
              _save_voice(tmp_path / "b.safetensors", seed=5)]
    texts = ["hi there", "and you"]
    want = next(jm.generate(texts, voice=voices, max_tokens=6, seed=1))
    got = next(pm.generate(texts, voice=voices, max_tokens=6, seed=1))
    _assert_same(got, want)
    assert got.samples == 2 * 6 * 4
    dur = got.samples / got.sample_rate
    assert got.real_time_factor == round(dur / got.processing_time_seconds,
                                         2)


def test_voice_lengths_and_tokenizer_errors(tmp_path):
    pm = _port()
    bad = _save_voice(tmp_path / "bad.safetensors", pos_len=3, neg_len=4)
    with pytest.raises(ValueError, match="lengths differ"):
        pm.load_voice(bad)
    with pytest.raises(FileNotFoundError):
        pm.load_voice("nobody")
    pm.tokenizer = None
    with pytest.raises(RuntimeError, match="tokenizer"):
        next(pm.generate("hi"))


# ---------------------------------------------------------------------------
# loading
# ---------------------------------------------------------------------------


def test_sanitize_takes_torch_layouts_as_jax_does():
    """One torch-layout checkpoint through both packages' sanitize: the JAX
    package converts its conv kernels to WIO, the port keeps them; bound,
    the two hold the same parameters."""
    from mlx_audio_tpu.utils import flatten, unflatten
    from mlx_audio_tpu_torch.model import load_jax_params
    from mlx_audio_tpu_torch.tts.models.vibevoice import Model

    jm, _ = _jax_model()
    pm = _port()
    ckpt = vibevoice_hf_state(pm)
    jflat = flatten(unflatten(jm.sanitize(
        {k: jnp.asarray(v) for k, v in ckpt.items()})))
    conv = "acoustic_tokenizer.decoder.stages.0.0.mixer.conv.conv.conv.weight"
    assert jflat[conv].shape == (7, 1, 16)
    via_jax = load_jax_params(
        Model(dataclasses.asdict(jm.config), device="cpu"),
        {k: np.asarray(v) for k, v in jflat.items()})
    direct = Model(dataclasses.asdict(jm.config), device="cpu")
    direct.bind(direct.sanitize(ckpt))
    want = via_jax.state_dict()
    got = direct.state_dict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), k)


@pytest.mark.parametrize("model_type", ["vibevoice_streaming", "vibevoice"])
def test_load_model_round_trip(tmp_path, model_type):
    from mlx_audio_tpu_torch import load_model

    pm = _port()
    write_tts_checkpoint(pm, vibevoice_hf_state(pm), model_type, tmp_path)
    loaded = load_model(tmp_path, device="cpu")
    assert loaded.tokenizer is None
    loaded.tokenizer = _FakeTok()
    want = next(pm.generate("hello", max_tokens=4, seed=2))
    got = next(loaded.generate("hello", max_tokens=4, seed=2))
    assert got.samples == want.samples > 0
    np.testing.assert_array_equal(got.audio, want.audio)


def test_post_load_hook_reads_only_the_local_directory(tmp_path):
    """No tokenizer files: None (JAX falls back to downloading
    Qwen/Qwen2.5-0.5B); files that do not load raise (JAX swallows it)."""
    pytest.importorskip("transformers")
    from mlx_audio_tpu_torch.tts.models.vibevoice import Model

    pm = _port()
    assert Model.post_load_hook(pm, tmp_path).tokenizer is None
    (tmp_path / "tokenizer.json").write_text("{not json")
    with pytest.raises(Exception):
        Model.post_load_hook(pm, tmp_path)


def test_entry_point_defaults_to_cuda():
    from mlx_audio_tpu_torch.tts.models.vibevoice import Model

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default does not raise")
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(dataclasses.asdict(_cfg()))
