"""Voxtral-4B-TTS of the PyTorch port against the JAX package, on the CPU:
the cases of tests/test_voxtral_tts.py (the text sanitizer, the acoustic
flow-matching head, the codec decoder, the frame loop, the voice
splice, sanitize), each held to the JAX package's: the text copy's
outputs equal, the velocity and the Euler state before rounding within
ATOL with the codes equal (a code on a rounding boundary would be named),
the codec's audio within ATOL, the frames of `generate` equal with JAX's
draws fed through the `_draws` seam, whole and streamed; then q8 against
the JAX package's q8, the departures (the codec decodes the frames it
has, the stop at `max_tokens`, a strict `post_load_hook`) and the loader.

Config: tests/test_voxtral_tts.py's tiny Voxtral-TTS (a 2-layer llama at
d32, one head layer, a two-stage codec at d16) and its FakeSpeechTok, one
parameter set drawn with numpy over JAX's shapes
(`test_torch_mimi.numpy_params`). ATOL = 2e-4 (f32, summation order)."""

import dataclasses
import json
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_mimi import flat_numpy, numpy_params  # noqa: E402
from test_voxtral_tts import FakeSpeechTok, _cfg  # noqa: E402

ATOL = 2e-4
TEXTS = ["hello", "# Title\n- a [x](http://u)", "It costs $1.50, or $3.",
         "In 1985 (about 3 ms) -- we sold 1,234,567 units... really?!",
         "Prices: £2.05 and €0.99; ¥300 (N/A) x >= 2", "2023 was 2.75 -1"]
NUMBERS = ["1985", "2023", "2000", "2005", "1900", "1,234", "3.14", "-42",
           "0", "12", "1234567"]
CURRENCIES = ["$1.50", "$3", "£2.05", "€0.99", "¥300", "¢5", "$0.01",
              "$1.234", "₹12.5"]


@pytest.fixture(scope="module")
def jax_head(models):
    """JAX's `acoustic_decode_frame` and `acoustic_velocity` on the tiny
    config, jitted once."""
    from mlx_audio_tpu.tts.models.voxtral_tts import voxtral_tts as jv

    cfg = models[0].config
    return (jax.jit(lambda p, x, k: jv.acoustic_decode_frame(p, cfg, x, k)),
            jax.jit(lambda p, *a: jv.acoustic_velocity(p, cfg, *a)))


@pytest.fixture(scope="module")
def models():
    """(JAX Voxtral-TTS, port Voxtral-TTS, the flat tree) on one weight
    set, each with FakeSpeechTok."""
    from mlx_audio_tpu.tts.models.voxtral_tts import Model as JModel
    from mlx_audio_tpu.utils import unflatten
    from mlx_audio_tpu_torch.model import load_jax_params
    from mlx_audio_tpu_torch.tts.models.voxtral_tts import Model

    jm = JModel(_cfg())
    flat = flat_numpy(numpy_params(jm.init_params, 0))
    jm.bind(unflatten({k: jnp.asarray(v) for k, v in flat.items()}))
    pm = load_jax_params(Model(dataclasses.asdict(_cfg()), device="cpu"),
                         flat)
    jm.tokenizer, pm.tokenizer = FakeSpeechTok(), FakeSpeechTok()
    return jm, pm, flat


def jax_frame_noise(seed: int, n: int, dims: int) -> list:
    """The noise JAX's frame loop draws for its first n frames: each
    frame splits the loop's key, and `acoustic_decode_frame` splits the
    frame's key once more before its normal draw."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(n):
        key, sub = jax.random.split(key)
        _, sub = jax.random.split(sub)
        out.append(np.asarray(jax.random.normal(sub, (1, dims))))
    return out


def feed(pm, draws):
    it = iter(draws)
    pm._draws = lambda generator: torch.from_numpy(np.array(next(it)))


def jax_frames(jm, ids, max_tokens: int, seed: int = 0) -> np.ndarray:
    """The JAX package's kept frames of `generate` (its prefill, its
    25-frame chunks until the stop or max_tokens), cut to max_tokens."""
    from mlx_audio_tpu.tts.models.voxtral_tts.voxtral_tts import (
        DEC_CHUNK, _bucket, pad_to_multiple)

    embeds = jm._build_input_embeddings(np.asarray(ids, np.int32),
                                        "casual_male")
    plen = embeds.shape[1]
    pb = _bucket(plen)
    embeds = jnp.pad(embeds, ((0, 0), (0, pb - plen), (0, 0)))
    cap = pb + 1 + pad_to_multiple(max_tokens + 1, DEC_CHUNK)
    fns = jm._jit_cache.get(("dec", pb, cap))
    if fns is None:
        fns = jm._jit_cache[("dec", pb, cap)] = jm._decode_fns(pb, cap)
    prefill, chunk = fns
    caches, h = prefill(jm.params, embeds, jnp.int32(plen))
    key, offset, done = jax.random.PRNGKey(seed), jnp.int32(plen + 1), \
        jnp.asarray(False)
    frames, steps = [], 0
    while steps < max_tokens:
        (caches, offset, h, key, done), codes, valid = chunk(
            jm.params, caches, offset, h, key, done)
        frames += [c for c, v in zip(np.asarray(codes), np.asarray(valid))
                   if v]
        steps += DEC_CHUNK
        if bool(done):
            break
    return np.asarray(frames[:max_tokens])


# ---------------------------------------------------------------------------
# text and config
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("text", TEXTS)
def test_sanitizer_copy_equals_jax(text):
    from mlx_audio_tpu.tts.models.voxtral_tts import text_preprocess as jt
    from mlx_audio_tpu_torch.tts.models.voxtral_tts import \
        text_preprocess as pt

    assert pt.sanitize_tts_input_text_for_demo(text) == \
        jt.sanitize_tts_input_text_for_demo(text)


def test_numbers_currencies_and_the_jax_tests_cases():
    from mlx_audio_tpu.tts.models.voxtral_tts import text_preprocess as jt
    from mlx_audio_tpu_torch.tts.models.voxtral_tts import \
        text_preprocess as pt

    for n in NUMBERS:
        assert pt.verbalize_number(n) == jt.verbalize_number(n)
    for c in CURRENCIES:
        for short in (False, True):
            assert pt.verbalize_currency(c, short=short) == \
                jt.verbalize_currency(c, short=short)
    assert pt.verbalize_currency("$1.50") == "one dollar and fifty cents"
    assert pt.verbalize_number("1985") == "nineteen eighty-five"
    assert pt.sanitize_tts_input_text_for_demo("hello").endswith(".")
    with pytest.raises(ValueError):
        pt.sanitize_tts_input_text_for_demo("​")


def test_params_json_flattening_equals_jax():
    from mlx_audio_tpu.tts.models.voxtral_tts import ModelConfig as JConfig
    from mlx_audio_tpu_torch.tts.models.voxtral_tts import ModelConfig

    params = {"dim": 64, "n_layers": 3, "vocab_size": 500, "multimodal": {
        "bos_token_id": 2,
        "audio_model_args": {
            "semantic_codebook_size": 100, "audio_token_id": 30,
            "audio_encoding_args": {"sampling_rate": 16000,
                                    "frame_rate": 25.0},
            "acoustic_transformer_args": {"dim": 48, "n_layers": 2}},
        "audio_tokenizer_args": {"dim": 32, "pretransform_patch_size": 120}}}
    a, b = ModelConfig.from_dict(params), JConfig.from_dict(params)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert (a.acoustic_dim, a.tokenizer_patch_size, a.audio_token_id) == \
        (48, 120, 30)
    assert a.samples_per_frame == b.samples_per_frame
    assert a.audio_embedding_size == b.audio_embedding_size


# ---------------------------------------------------------------------------
# the acoustic head and the codec
# ---------------------------------------------------------------------------


def test_velocity_equals_jax(models, jax_head):
    from mlx_audio_tpu_torch.tts.models.voxtral_tts.voxtral_tts import \
        acoustic_velocity

    jm, pm, _ = models
    rng = np.random.RandomState(1)
    c = pm.config
    x = rng.randn(4, c.n_acoustic_codebook).astype(np.float32)
    t = rng.rand(4).astype(np.float32)
    h = rng.randn(4, c.dim).astype(np.float32)
    want = jax_head[1](jm.params["acoustic_transformer"],
                       *map(jnp.asarray, (x, t, h)))
    with torch.inference_mode():
        got = acoustic_velocity(pm.acoustic_transformer, c,
                                *map(torch.from_numpy, (x, t, h)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("seed", range(4))
def test_frame_state_and_codes_equal_jax(models, jax_head, seed):
    """The Euler state before rounding within ATOL of JAX's (its own
    velocity in its own loop), and the frame's codes equal JAX's
    `acoustic_decode_frame` on the same noise."""
    from mlx_audio_tpu_torch.tts.models.voxtral_tts import voxtral_tts as pv

    jm, pm, _ = models
    frame, vel = jax_head
    c = pm.config
    h = np.random.RandomState(seed).randn(1, c.dim).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    codes = np.asarray(frame(jm.params["acoustic_transformer"],
                             jnp.asarray(h), key))
    _, sub = jax.random.split(key)
    noise = np.asarray(jax.random.normal(sub, (1, c.n_acoustic_codebook)))
    n = c.n_denoising_steps
    ts = [i / (n - 1) for i in range(n)]
    x = jnp.asarray(noise) * c.acoustic_sigma_max
    pair = jnp.concatenate([jnp.asarray(h), jnp.zeros_like(jnp.asarray(h))])
    for step in range(n - 1):
        v = vel(jm.params["acoustic_transformer"], jnp.tile(x, (2, 1)),
                jnp.full((2,), ts[step], jnp.float32), pair)
        v = c.cfg_alpha * v[:1] + (1.0 - c.cfg_alpha) * v[1:]
        x = x + v * (ts[step + 1] - ts[step])
    with torch.inference_mode():
        th, tn = torch.from_numpy(h), torch.from_numpy(noise)
        state = pv.acoustic_levels(pm.acoustic_transformer, c, th, tn)
        got = pv.acoustic_decode_frame(pm.acoustic_transformer, c, th, tn)
    np.testing.assert_allclose(state.numpy(), np.asarray(x), atol=ATOL)
    levels = (np.clip(np.asarray(x), -1, 1) + 1) * \
        (c.acoustic_codebook_size - 1) / 2
    edge = np.abs(levels - np.floor(levels) - 0.5).min()
    assert np.array_equal(got.numpy(), codes), \
        f"codes differ; the nearest level sits {edge:.2e} from a boundary"
    assert got[0, 0] >= 1 and (got[0, 1:] >= 2).all()


@pytest.mark.parametrize("n", [1, 6, 8, 13])
def test_codec_equals_jax(models, n):
    from mlx_audio_tpu.tts.models.voxtral_tts.voxtral_tts import \
        audio_decode as jdec
    from mlx_audio_tpu_torch.tts.models.voxtral_tts.voxtral_tts import \
        audio_decode

    jm, pm, _ = models
    rng = np.random.RandomState(n)
    codes = np.concatenate([rng.randint(0, 68, (1, n, 1)),
                            rng.randint(2, 7, (1, n, 6))], axis=2)
    want = np.asarray(jax.jit(lambda p, x: jdec(p, jm.config, x))(
        jm.params["audio_tokenizer"], jnp.asarray(codes, jnp.int32)))
    with torch.inference_mode():
        got = audio_decode(pm.audio_tokenizer, pm.config,
                           torch.from_numpy(codes)).numpy()
    assert got.shape == want.shape == (1, n * pm.config.samples_per_frame)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_codec_runs_its_frames_as_jaxs_bucket(models):
    """JAX pads the codes to a multiple of 64 frames; the decoder is
    causal, so the port, which decodes the frames it has, gives JAX's
    samples (no fault; JAX's own test_causal_bucketing_matches_exact)."""
    jm, pm, _ = models
    rng = np.random.RandomState(0)
    codes = np.concatenate([rng.randint(2, 6, (6, 1)),
                            rng.randint(2, 7, (6, 6))], axis=1)
    got = pm.decode_audio_codes(codes)
    np.testing.assert_allclose(got, jm.decode_audio_codes(codes), atol=ATOL)
    assert got.shape == (6 * pm.config.samples_per_frame,)


def test_global_offsets_and_voice_splice_equal_jax(models):
    jm, pm, _ = models
    np.testing.assert_array_equal(pm._global_offsets(),
                                  jm._global_offsets())
    ids = np.asarray([1, 5, 24, 24, 25, 24], np.int32)
    voice = np.random.RandomState(0).randn(2, pm.config.dim).astype(
        np.float32)
    for m in (jm, pm):
        m._voice_embeddings["casual_male"] = voice
    try:
        got = pm._build_input_embeddings(ids, "casual_male").numpy()
        want = np.asarray(jm._build_input_embeddings(ids, "casual_male"))
    finally:
        for m in (jm, pm):
            del m._voice_embeddings["casual_male"]
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_array_equal(got[0, 2:4], voice)


# ---------------------------------------------------------------------------
# the frame loop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("max_tokens", [25, 10])
def test_frames_and_audio_equal_jax(models, max_tokens):
    """One chunk of 25 frames, and 10 (JAX runs its whole chunk and keeps
    10; the port runs 10): the frames with JAX's draws, the audio of
    `generate`."""
    jm, pm, _ = models
    ids = FakeSpeechTok().encode_speech("hello there.", "casual_male")
    want = jax_frames(jm, ids, max_tokens)
    feed(pm, jax_frame_noise(0, max_tokens, pm.config.n_acoustic_codebook))
    state = pm.start(pm._build_input_embeddings(ids, "casual_male"),
                     max_tokens)
    got, stopped = pm.chunk(state)
    assert stopped and state["frames"] == max_tokens
    np.testing.assert_array_equal(got, want)
    feed(pm, jax_frame_noise(0, max_tokens, pm.config.n_acoustic_codebook))
    (a,) = list(pm.generate("hello there", max_tokens=max_tokens, seed=0))
    (b,) = list(jm.generate("hello there", max_tokens=max_tokens, seed=0))
    assert a.token_count == b.token_count == len(want)
    np.testing.assert_allclose(a.audio, np.asarray(b.audio), atol=ATOL)
    assert pm.last_run["frames_run"] == max_tokens


def test_end_audio_stops_as_jax(models):
    """The semantic head's end-audio row scaled until greedy decoding
    draws it within the first chunk: both packages keep the frames before
    it, the port's loop stops after that chunk's read."""
    jm, pm, flat = models
    from mlx_audio_tpu.utils import unflatten

    key = "acoustic_transformer.semantic_codebook_output.weight"
    ids = FakeSpeechTok().encode_speech("stop here.", "casual_male")
    base = pm.acoustic_transformer.semantic_codebook_output.weight.clone()
    n = pm.config.n_acoustic_codebook
    try:
        for scale in (1.5, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0):
            w = base.clone()
            w[1] *= scale
            pm.acoustic_transformer.semantic_codebook_output.weight.copy_(w)
            feed(pm, jax_frame_noise(0, 40, n))
            state = pm.start(pm._build_input_embeddings(ids, "casual_male"),
                             40)
            got, stopped = pm.chunk(state)
            if stopped and 2 <= len(got) < 25:
                break
        assert stopped and 2 <= len(got) < 25, "no scale stops the chunk"
        tree = dict(flat, **{key: w.numpy()})
        jm.bind(unflatten({k: jnp.asarray(v) for k, v in tree.items()}))
        np.testing.assert_array_equal(got, jax_frames(jm, ids, 40))
    finally:
        pm.acoustic_transformer.semantic_codebook_output.weight.copy_(base)
        jm.bind(unflatten({k: jnp.asarray(v) for k, v in flat.items()}))


def test_streamed_generate_equals_jax(models):
    """A stream at 0.8 s (10 frames) over 30 frames, 16 frames of codec
    context: the chunks' samples and counts."""
    jm, pm, _ = models
    ids = FakeSpeechTok().encode_speech("a stream.", "casual_male")
    frames = jax_frames(jm, ids, 25)
    feed(pm, jax_frame_noise(0, 25, pm.config.n_acoustic_codebook))
    got = list(pm.generate("a stream", max_tokens=25, seed=0, stream=True,
                           streaming_interval=0.8))
    want = list(jm.generate("a stream", max_tokens=25, seed=0, stream=True,
                            streaming_interval=0.8))
    assert [r.token_count for r in got] == [r.token_count for r in want]
    assert [r.is_final_chunk for r in got] == \
        [r.is_final_chunk for r in want]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.audio, np.asarray(b.audio), atol=ATOL)
    whole = pm.decode_audio_codes(frames)
    np.testing.assert_allclose(np.concatenate([r.audio for r in got]),
                               whole, atol=ATOL)


def test_generate_without_a_speech_tokenizer_raises(models):
    from mlx_audio_tpu_torch.tts.models.voxtral_tts import Model

    m = Model(dataclasses.asdict(_cfg()), device="cpu")
    with pytest.raises(RuntimeError, match="mistral-common"):
        list(m.generate("hi"))
    m.tokenizer = object()
    with pytest.raises(RuntimeError, match="encode_speech"):
        list(m.generate("hi"))


# ---------------------------------------------------------------------------
# q8 and loading
# ---------------------------------------------------------------------------


def test_q8_runs_and_equals_jax_q8(models, tmp_path):
    """q8 at group 16 in both packages: JAX's runs (its rule skips the
    tables, the convs, whose last axis is the kernel, and every leaf named
    like a codebook); the port's directory quantizes the same linears
    (the LM's, the codec's and the head's but `input_projection` and the
    two codebook heads) and gives JAX's frames and audio."""
    from mlx_audio_tpu.tts.models.voxtral_tts import Model as JModel
    from mlx_audio_tpu.utils import apply_quantization, flatten, unflatten
    from mlx_audio_tpu_torch.nn import Linear, QuantizedLinear
    from mlx_audio_tpu_torch.utils import load_model

    jm, pm, flat = models
    q = {"quantization": {"group_size": 16, "bits": 8}}
    jq = JModel(_cfg())
    jq.bind(apply_quantization(unflatten(
        {k: jnp.asarray(v) for k, v in flat.items()}), q))
    jq.tokenizer = FakeSpeechTok()
    jkeys = {k[:-len(".w_q")] for k in flatten(jq.params)
             if k.endswith(".w_q")}
    d = tmp_path / "voxtral-tts-q8"
    d.mkdir()
    (d / "config.json").write_text(json.dumps(dict(
        dataclasses.asdict(_cfg()), model_type="voxtral_tts", **q)))
    np.savez(d / "model.npz", **flat)
    m = load_model(str(d), device="cpu")
    m.tokenizer = FakeSpeechTok()
    held = {n for n, x in m.named_modules() if isinstance(x, QuantizedLinear)}
    dense = {n for n, x in m.named_modules() if isinstance(x, Linear)}
    assert held == jkeys and len(held) == 37
    assert dense == {"acoustic_transformer.input_projection",
                     "acoustic_transformer.semantic_codebook_output",
                     "acoustic_transformer.acoustic_codebook_output"}
    ids = FakeSpeechTok().encode_speech("hello there.", "casual_male")
    want = jax_frames(jq, ids, 12)
    feed(m, jax_frame_noise(0, 12, m.config.n_acoustic_codebook))
    (a,) = list(m.generate("hello there", max_tokens=12, seed=0))
    (b,) = list(jq.generate("hello there", max_tokens=12, seed=0))
    assert a.token_count == b.token_count == len(want)
    np.testing.assert_allclose(a.audio, np.asarray(b.audio), atol=ATOL)


def test_sanitize_equals_jax(models):
    """The JAX test's checkpoint (Mistral names, a weight-norm pair) and
    the head's and codec's own names: the same tree."""
    jm, pm, _ = models
    rng = np.random.RandomState(0)
    w = {"layers.0.attention.wq.weight": rng.randn(32, 32),
         "layers.1.feed_forward.w2.weight": rng.randn(32, 64),
         "layers.0.ffn_norm.weight": rng.randn(32),
         "tok_embeddings.weight": rng.randn(128, 32),
         "norm.weight": rng.randn(32), "output.weight": rng.randn(128, 32),
         "mm_audio_embeddings.audio_codebook_embeddings.embeddings.weight":
             rng.randn(256, 32),
         "acoustic_transformer.norm.weight": rng.randn(32),
         "audio_tokenizer.decoder_blocks.0.conv."
         "parametrizations.weight.original0": np.ones((16, 1, 1)) * 2,
         "audio_tokenizer.decoder_blocks.0.conv."
         "parametrizations.weight.original1": rng.randn(16, 14, 3),
         "audio_tokenizer.output_proj.conv."
         "parametrizations.weight.original1": rng.randn(4, 16, 3)}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    a, b = pm.sanitize(w), jm.sanitize(w)
    assert sorted(a) == sorted(b) and "output.weight" not in a
    for k in a:
        np.testing.assert_allclose(a[k], np.asarray(b[k]), atol=1e-6)
    norms = np.linalg.norm(a["audio_tokenizer.decoder_blocks.0.conv.weight"]
                           .reshape(16, -1), axis=1)
    np.testing.assert_allclose(norms, 2.0, atol=1e-5)


def test_post_load_hook_reads_the_directory_strictly(tmp_path):
    """A departure: a tekken.json that fails to parse raises (JAX's hook
    warns); without `mistral_common` the tokenizer stays None silently
    (JAX's warns) and `generate` names what it needs; the voice files are
    registered by name."""
    from mlx_audio_tpu.tts.models.voxtral_tts import Model as JModel
    from mlx_audio_tpu_torch.tts.models.voxtral_tts import Model

    m = Model(dataclasses.asdict(_cfg()), device="cpu")
    (tmp_path / "voice_embedding").mkdir()
    (tmp_path / "voice_embedding" / "neutral_female.safetensors").write_bytes(
        b"")
    assert Model.post_load_hook(m, tmp_path).tokenizer is None
    assert list(m._voice_embedding_files) == ["neutral_female"]
    (tmp_path / "tekken.json").write_text(json.dumps({"special_tokens": [
        {"token_str": "[NEXT_AUDIO_TEXT]", "rank": 35},
        {"token_str": "[REPEAT_AUDIO_TEXT]", "rank": 36}]}))
    try:
        import mistral_common  # noqa: F401
    except ImportError:
        Model.post_load_hook(m, tmp_path)
        assert (m._text_to_audio_token_id, m._audio_to_text_token_id,
                m.tokenizer) == (35, 36, None)
    (tmp_path / "tekken.json").write_text("{broken")
    with pytest.raises(json.JSONDecodeError):
        Model.post_load_hook(m, tmp_path)
    jm = JModel(_cfg())
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        JModel.post_load_hook(jm, tmp_path)
    assert any("tekken" in str(c.message) for c in caught)


def test_load_model_from_a_directory(models, tmp_path):
    """A Voxtral-TTS directory (config.json, the JAX tree in npz) through
    the top-level `load_model` on the CPU gives the bound model's frames;
    the card is the default."""
    from mlx_audio_tpu_torch.utils import load_model

    _, pm, flat = models
    d = tmp_path / "voxtral-4b-tts-tiny"
    d.mkdir()
    (d / "config.json").write_text(json.dumps(dict(
        dataclasses.asdict(_cfg()), model_type="voxtral_tts")))
    np.savez(d / "model.npz", **flat)
    m = load_model(str(d), device="cpu")
    assert type(m).__module__.endswith("voxtral_tts.voxtral_tts")
    m.tokenizer = FakeSpeechTok()
    noise = jax_frame_noise(3, 8, pm.config.n_acoustic_codebook)
    outs = []
    for model in (m, pm):
        feed(model, noise)
        outs.append(list(model.generate("hi there", max_tokens=8))[0].audio)
    np.testing.assert_array_equal(*outs)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            load_model(str(d))
