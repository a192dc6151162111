"""Kokoro text -> audio in the PyTorch port against the JAX package, on the
tiny config (tests/tiny_configs.py), CPU, float32.

The JAX model's random parameters are carried into the port by
`load_jax_params`. Audio is compared by relative error max|a-b| / max|b|:
random weights put the waveform near 1e10, so an absolute tolerance says
nothing. Noise is off (`deterministic_noise=True`) wherever the two
packages are compared, since their random streams differ.

Durations are the one discontinuity: round(sum of sigmoids) can flip at .5
on a last-bit difference and change every shape downstream. So the float
durations are compared with a tolerance, the rounded ones must be equal at
this seed, and the acoustic stage is also run on JAX's own durations.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tiny_configs import tiny_kokoro_config  # noqa: E402

# f32 on both sides, summation order only: 2e-4 absolute on the O(1)
# frontend features (tests/test_torch_parity.py:19), 1e-4 relative on the
# audio, whose deep generator amplifies last-bit differences through exp()
ATOL = 2e-4
AUDIO_REL = 1e-4
PHONEMES = "hɛlO wɜɹld"


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-30)


def _port_model(flat, **overrides):
    from mlx_audio_tpu_torch.tts.models.kokoro import (Model, ModelConfig,
                                                       load_jax_params)

    cfg = dataclasses.asdict(tiny_kokoro_config())
    cfg.update(overrides)
    return load_jax_params(Model(ModelConfig.from_dict(cfg), device="cpu"),
                           flat)


@pytest.fixture(scope="module")
def jax_model():
    from mlx_audio_tpu.tts.models.kokoro import Model

    return Model(tiny_kokoro_config()).init_and_bind()


@pytest.fixture(scope="module")
def flat(jax_model):
    from mlx_audio_tpu.utils import flatten

    return {k: np.asarray(v) for k, v in flatten(jax_model.params).items()}


@pytest.fixture(scope="module")
def port(flat):
    return _port_model(flat)


@pytest.fixture(scope="module")
def ref_s():
    return np.random.RandomState(0).randn(1, 32).astype(np.float32)


def _batch(model, texts, bucket=32):
    """Two right-padded rows of token ids, as Model.__call__ builds one."""
    rows = [[0, *model.phonemes_to_ids(t), 0] for t in texts]
    ids = np.zeros((len(rows), bucket), np.int32)
    valid = np.zeros((len(rows), bucket), bool)
    for i, r in enumerate(rows):
        ids[i, :len(r)] = r
        valid[i, :len(r)] = True
    return ids, valid


def _ref_b(b):
    return np.random.RandomState(2).randn(b, 32).astype(np.float32)


@pytest.fixture(scope="module")
def frontends(jax_model, port):
    """(jax outputs, port outputs) of the frontend on a B=2 ragged batch."""
    ids, valid = _batch(port, [PHONEMES, "ðə kæt"])
    ref = _ref_b(2)
    frontend, _ = jax_model._get_jits()
    j = frontend(jax_model.params, jnp.asarray(ids), jnp.asarray(valid),
                 jnp.asarray(ref), jnp.float32(1.0))
    with torch.inference_mode():
        t = port._run_frontend(torch.from_numpy(ids).long(),
                               torch.from_numpy(valid), torch.from_numpy(ref),
                               1.0)
    return ids, valid, ref, j, t


def test_frontend_matches_jax(jax_model, port, frontends):
    from mlx_audio_tpu.nn import apply_linear, apply_lstm
    from mlx_audio_tpu_torch.tts.models.kokoro.modules import float_durations

    _, valid, _, (jd, jt, jpd, jtot), (td, tt, tpd, ttot) = frontends
    m = valid[..., None]
    np.testing.assert_allclose(np.where(m, td.numpy(), 0), np.where(m, jd, 0),
                               atol=ATOL, rtol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=ATOL, rtol=1e-5)

    p = jax_model.params["predictor"]
    x = apply_lstm(p["lstm"], jd, bidirectional=True, mask=jnp.asarray(valid))
    jfloat = np.asarray(jax.nn.sigmoid(
        apply_linear(p["duration_proj"]["linear_layer"], x)).sum(-1))
    with torch.inference_mode():
        tfloat = float_durations(port.predictor, td,
                                 torch.from_numpy(valid)).numpy()
    np.testing.assert_allclose(tfloat[valid], jfloat[valid], atol=ATOL, rtol=1e-5)
    # no float duration lies within the tolerance of a .5, so the rounded
    # durations must agree exactly
    frac = jfloat[valid] - np.floor(jfloat[valid])
    assert np.abs(frac - 0.5).min() > ATOL
    np.testing.assert_array_equal(tpd.numpy(), np.asarray(jpd))
    assert int(ttot) == int(jtot)


@pytest.mark.parametrize("batch", [1, 2])
def test_acoustic_matches_jax_on_jax_durations(jax_model, port, frontends,
                                               batch):
    """The acoustic stage fed JAX's own d, t_en and durations. batch=2 runs
    two rows with different totals in one call, each with its own masks."""
    from mlx_audio_tpu_torch.tts.models.kokoro import FRAME_BUCKETS
    from mlx_audio_tpu_torch.tts.models.kokoro.kokoro import _bucket

    _, _, ref, (jd, jt, jpd, _), _ = frontends
    jd, jt, jpd, ref = jd[:batch], jt[:batch], jpd[:batch], ref[:batch]
    totals = np.asarray(jpd).sum(-1)
    if batch == 2:
        assert totals[0] != totals[1]
    fb = _bucket(int(totals.max()), FRAME_BUCKETS)
    _, acoustic = jax_model._get_jits()
    ja, jtot = acoustic(jax_model.params, jd, jt, jpd, jnp.asarray(ref),
                        num_frames=fb, key=None)
    with torch.inference_mode():
        ta, ttot = port._run_acoustic(
            torch.tensor(np.asarray(jd)), torch.tensor(np.asarray(jt)),
            torch.tensor(np.asarray(jpd)).long(), torch.from_numpy(ref), fb)
    np.testing.assert_array_equal(ttot.numpy(), np.asarray(jtot))
    ja = np.asarray(ja)
    for b in range(batch):
        n = int(totals[b]) * port.samples_per_frame
        assert _rel(ta[b, :n].numpy(), ja[b, :n]) < AUDIO_REL


def test_call_matches_jax(jax_model, port, ref_s):
    """The whole text(phonemes) -> audio __call__, bucketed, at f32."""
    ja, jdur = jax_model(PHONEMES, ref_s, deterministic_noise=True)
    ta, tdur = port(PHONEMES, ref_s, deterministic_noise=True)
    np.testing.assert_array_equal(tdur.numpy(), np.asarray(jdur))
    assert ta.dtype == np.float32 and ta.shape == ja.shape
    assert np.isfinite(ta).all()
    assert _rel(ta, ja) < AUDIO_REL


def test_bucket_invariance(port, ref_s):
    """Padded (bucketed) shapes give the tight shapes' audio in the valid
    region (the criterion of tests/test_kokoro.py:36-47)."""
    audio_b, _ = port(PHONEMES, ref_s, deterministic_noise=True)
    audio_t, _ = port(PHONEMES, ref_s, deterministic_noise=True, tight=True)
    assert audio_b.shape == audio_t.shape
    cut = len(audio_t) - 10 * port.samples_per_frame
    assert _rel(audio_b[:cut], audio_t[:cut]) < 2e-4


def test_generate_through_pipeline(port, tmp_path):
    """generate() with an .npy voice pack and the built-in G2P: one result
    per segment, each equal to the model's own call on its phonemes."""
    from mlx_audio_tpu_torch.tts.models.kokoro import Model

    vdir = tmp_path / "voices"
    vdir.mkdir()
    pack = np.random.RandomState(1).randn(510, 1, 32).astype(np.float32)
    np.save(vdir / "af_test.npy", pack)
    model = Model(port.config, device="cpu")
    model.load_state_dict(port.state_dict())
    model.config = dataclasses.replace(port.config, model_path=str(tmp_path))
    results = list(model.generate("Hello world. This is a test.",
                                  voice="af_test", split_pattern=r"\."))
    assert len(results) == 2
    pipeline = model._pipelines["a"]
    for r, text in zip(results, ["Hello world", "This is a test"]):
        ps = pipeline.phonemize(text)
        n = len(model.phonemes_to_ids(ps))
        want, dur = model(ps, pack[n - 1].reshape(1, -1))
        assert r.samples == int(dur.sum()) * model.samples_per_frame
        assert r.sample_rate == 24000 and r.real_time_factor >= 0
        np.testing.assert_array_equal(np.asarray(r.audio), want)


def test_load_model_matches_jax_loader(jax_model, port, ref_s, tmp_path):
    """One fake torch-layout checkpoint (weight-norm pairs, LSTM suffixes,
    (1,C,1) alphas; built as tests/test_kokoro.py:68-119 builds it) loaded
    by both packages' loaders gives the same parameters and audio."""
    import json

    from safetensors.numpy import save_file

    from mlx_audio_tpu.tts.utils import load_model as jax_load
    from mlx_audio_tpu.utils import flatten
    from mlx_audio_tpu_torch.tts.utils import load_model

    fake = {}
    for k, v in flatten(jax_model.params).items():
        v = np.asarray(v)
        if ".forward." in k or ".backward." in k:
            base, direction, name = k.rsplit(".", 2)
            suffix = name + "_l0" + ("_reverse" if direction == "backward" else "")
            fake[f"{base}.{suffix}"] = v
        elif k.endswith(".weight") and v.ndim == 3:
            if ".pool." in k:
                torch_w = np.transpose(np.flip(v, 0), (2, 1, 0))
            elif "generator.ups" in k:
                torch_w = np.transpose(np.flip(v, 0), (1, 2, 0))
            else:
                torch_w = np.transpose(v, (2, 1, 0))
            if "noise_convs" in k or "F0_proj" in k or "N_proj" in k:
                fake[k] = np.ascontiguousarray(torch_w)
            else:
                base = k[: -len(".weight")]
                norm = np.sqrt((torch_w ** 2).sum(axis=(1, 2), keepdims=True))
                fake[base + ".weight_v"] = np.ascontiguousarray(torch_w)
                fake[base + ".weight_g"] = norm
        elif ("alpha1" in k or "alpha2" in k) and v.ndim == 1:
            fake[k] = v.reshape(1, -1, 1)
        elif k.endswith("LayerNorm.weight"):
            fake[k[: -len(".weight")] + ".gamma"] = v
        elif k.endswith("LayerNorm.bias"):
            fake[k[: -len(".bias")] + ".beta"] = v
        else:
            fake[k] = v
    fake["bert.embeddings.position_ids"] = np.arange(128)[None]
    cfg = dataclasses.asdict(tiny_kokoro_config())
    cfg["model_type"] = "kokoro"
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    save_file(fake, str(tmp_path / "model.safetensors"))

    jm = jax_load(tmp_path)
    # reuse the fixture model's compiled stages (the params are arguments)
    jm._frontend_jit, jm._acoustic_jit = jax_model._get_jits()
    tm = load_model(tmp_path, device="cpu")
    ref_state = port.state_dict()
    for name, p in tm.state_dict().items():
        np.testing.assert_allclose(p.numpy(), ref_state[name].numpy(),
                                   atol=1e-6, err_msg=name)
    ja, _ = jm(PHONEMES, ref_s, deterministic_noise=True)
    ta, _ = tm(PHONEMES, ref_s, deterministic_noise=True)
    assert _rel(ta, ja) < AUDIO_REL


def test_bf16_decoder_tracks_f32(flat, port, ref_s):
    """The port's default bf16 decoder against its own f32 path, with the
    bound of tests/test_kokoro.py:123-149 (f32 transfer: random weights
    emit audio far outside f16's range)."""
    bf16 = _port_model(flat, compute_dtype="bfloat16")
    assert next(bf16.decoder.parameters()).dtype == torch.bfloat16
    a32, _ = port(PHONEMES, ref_s, deterministic_noise=True)
    a16, _ = bf16(PHONEMES, ref_s, deterministic_noise=True)
    assert a16.dtype == np.float32 and a16.shape == a32.shape
    assert _rel(a16, a32) < 0.15
    assert np.corrcoef(a16, a32)[0, 1] > 0.999


def test_f16_transfer_clamps(flat, ref_s):
    """transfer_dtype f16 clips to +-65504 instead of overflowing to inf."""
    m = _port_model(flat, transfer_dtype="float16")
    audio, _ = m(PHONEMES, ref_s, deterministic_noise=True)
    assert np.isfinite(audio).all()
    assert np.abs(audio).max() <= 65504.0
