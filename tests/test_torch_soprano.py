"""Soprano of the PyTorch port against the JAX package, on the CPU: the
cases of tests/test_soprano.py (the text cleanup, the prompts, the
hidden-state vocoder, the decode, sanitize), each held to the JAX
package's: the text copy's outputs equal, the LM's logits and hidden rows
and the vocoder's audio within ATOL, greedy tokens equal token for token
with their hidden rows within ATOL, the audio of `generate` within ATOL;
then the departures (the stop at `max_tokens`, the conv layouts read from
shapes, a strict `post_load_hook`) and the loader.

Config: tests/test_soprano.py's tiny Soprano (one Qwen3 layer at d16, 64
ids; a one-block Vocos at d16, n_fft 256, hop 64) and its _FakeTok, one
parameter set drawn with numpy over JAX's shapes
(`test_torch_mimi.numpy_params`); the JAX side runs its own jitted
decode. ATOL = 2e-4 (f32, summation order)."""

import json
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_soprano import _FakeTok  # noqa: E402
from test_torch_mimi import flat_numpy, numpy_params  # noqa: E402

ATOL = 2e-4
CFG = dict(hidden_size=16, num_hidden_layers=1, intermediate_size=32,
           num_attention_heads=2, num_key_value_heads=2, head_dim=8,
           vocab_size=64, sample_rate=16000,
           decoder_config=dict(decoder_num_layers=1, decoder_dim=16,
                               decoder_intermediate_dim=32, hop_length=64,
                               n_fft=256, upscale=4, input_kernel=1,
                               dw_kernel=3))
TEXT = "This is a long enough sentence to synthesize nicely."
TEXTS = ["Dr. Smith paid $5.50 on the 3rd!!", "21 items", "Hi.  Bye... ok",
         "Mr. & Mrs. Jones — 1,234,567 #1 100% @home 2.75",
         "This is a long enough first sentence, truly. Hi. Bye.",
         "Ünïcödé 21st 42nd 13th 101st $1 $0.01 $3."]


class LongTok(_FakeTok):
    """_FakeTok without its 40-id cap."""

    def encode(self, text, add_special_tokens=False):
        return [min(ord(c), 63) for c in text]


@pytest.fixture(scope="module")
def models():
    """(JAX Soprano, port Soprano, the flat tree) on one weight set, each
    with _FakeTok and the pad id as the stop."""
    from mlx_audio_tpu.tts.models.soprano import Model as JModel
    from mlx_audio_tpu.tts.models.soprano import ModelConfig as JConfig
    from mlx_audio_tpu.utils import unflatten
    from mlx_audio_tpu_torch.model import load_jax_params
    from mlx_audio_tpu_torch.tts.models.soprano import Model

    jm = JModel(JConfig.from_dict(CFG))
    flat = flat_numpy(numpy_params(jm.init_params, 0))
    jm.bind(unflatten({k: jnp.asarray(v) for k, v in flat.items()}))
    pm = load_jax_params(Model(CFG, device="cpu"), flat)
    for m in (jm, pm):
        m._tokenizer, m._stop_token_id = _FakeTok(), 2
    return jm, pm, flat


def jax_decode(jm, ids, max_tokens, stop_id=2):
    """The JAX package's decode of `generate` (its prefill and 32-step
    chunks until max_tokens kept tokens or the stop), greedy -> (tokens,
    hidden rows (L, D) after the prompt's last)."""
    from mlx_audio_tpu.tts.models.soprano.soprano import PROMPT_BUCKETS

    n = len(ids)
    pb = next(b for b in PROMPT_BUCKETS if n <= b)
    padded = np.zeros((1, pb), np.int32)
    padded[0, :n] = ids
    prefill, chunk = jm._fns(pb, max_tokens, 0.0, 0.95, stop_id)
    lg, hid0, caches = prefill(jm.params, jnp.asarray(padded),
                               jnp.asarray([n]))
    rows, toks = [np.asarray(hid0)[0, 0]], []
    rng, done, t = jax.random.PRNGKey(0), jnp.bool_(False), jnp.int32(n)
    while len(toks) < max_tokens:
        lg, caches, rng, done, tk, hd = chunk(jm.params, lg, caches, t, rng,
                                              done)
        t = t + 32
        tk, hd = np.asarray(tk), np.asarray(hd)
        toks += [int(x) for x in tk if x >= 0]
        rows += [hd[i, 0] for i in range(len(tk)) if tk[i] >= 0]
        if bool(done):
            break
    return toks, np.stack(rows)


# ---------------------------------------------------------------------------
# text
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("text", TEXTS)
def test_text_copy_equals_jax(text):
    from mlx_audio_tpu.tts.models.soprano import Model as JModel
    from mlx_audio_tpu.tts.models.soprano import clean_text as jclean
    from mlx_audio_tpu_torch.tts.models.soprano import Model, clean_text

    assert clean_text(text) == jclean(text)
    for min_length in (0, 30):
        assert Model.preprocess_text(text, min_length) == \
            JModel.preprocess_text(text, min_length)


def test_text_cases_of_the_jax_tests():
    from mlx_audio_tpu_torch.tts.models.soprano import Model, clean_text

    out = clean_text("Dr. Smith paid $5.50 on the 3rd!!")
    assert "doctor" in out and "five dollars" in out and "third" in out
    assert "fifty cents" in out and "!!" not in out
    assert "twenty one" in clean_text("21 items")
    prompts = Model.preprocess_text(
        "This is a long enough first sentence, truly. Hi. Bye.")
    assert prompts == ["[STOP][TEXT]this is a long enough first sentence, "
                       "truly. hi. bye.[START]"]


@pytest.mark.parametrize("path", ["", "/m/soprano-1.1-80m", "/m/soprano-80m"])
def test_decoder_variant_from_the_directory_name(path):
    from mlx_audio_tpu.tts.models.soprano import ModelConfig as JConfig
    from mlx_audio_tpu_torch.tts.models.soprano import ModelConfig

    a, b = ModelConfig(model_path=path), JConfig(model_path=path)
    assert vars(a.decoder_config) == vars(b.decoder_config)


# ---------------------------------------------------------------------------
# the LM and the vocoder
# ---------------------------------------------------------------------------


def test_lm_forward_equals_jax(models):
    """A 24-row prompt: the logits and the post-norm hidden rows."""
    from mlx_audio_tpu.tts.models.soprano.soprano import lm_forward as jlm
    from mlx_audio_tpu_torch.tts.models.soprano.soprano import lm_forward

    jm, pm, _ = models
    ids = np.random.RandomState(0).randint(0, 64, (1, 24))
    jl, jh, _ = jax.jit(lambda p, x: jlm(p, jm.config, x, None, 0))(
        jm.params, jnp.asarray(ids))
    with torch.inference_mode():
        pl, ph = lm_forward(pm, pm.language_model.embed_tokens(
            torch.from_numpy(ids)), None, 0)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=ATOL)
    np.testing.assert_allclose(ph.numpy(), np.asarray(jh), atol=ATOL)


@pytest.mark.parametrize("length", [1, 5, 10])
def test_decode_hidden_equals_jax(models, length):
    """The vocoder: 4x interpolation, the ConvNeXt block, the head, the
    ISTFT; JAX's test's shapes (37 frames from 10 rows)."""
    from mlx_audio_tpu.tts.models.soprano.soprano import \
        decode_hidden as jdec
    from mlx_audio_tpu_torch.tts.models.soprano.soprano import decode_hidden

    jm, pm, _ = models
    h = (np.random.RandomState(length).randn(1, length, 16) * 0.5).astype(
        np.float32)
    want = np.asarray(jax.jit(lambda p, x: jdec(p, jm.config, x, None))(
        jm.params, jnp.asarray(h)))
    with torch.inference_mode():
        got = decode_hidden(pm, torch.from_numpy(h)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------


def test_greedy_generate_equals_jax(models):
    """32 greedy tokens, one JAX chunk: the tokens, their hidden rows and
    the audio of `generate`."""
    jm, pm, _ = models
    ids = _FakeTok().encode(pm.preprocess_text(TEXT)[0])
    jt, jr = jax_decode(jm, ids, 32)
    pt, pr = pm.decode_tokens(ids, 32, 0.0, 0.95, 0)
    assert pt == jt and len(pt) == 32
    np.testing.assert_allclose(pr[0].numpy(), jr, atol=ATOL)
    (a,) = list(pm.generate(TEXT, max_tokens=32, temperature=0.0))
    (b,) = list(jm.generate(TEXT, max_tokens=32, temperature=0.0))
    assert a.token_count == b.token_count == 32
    assert a.samples == b.samples
    np.testing.assert_allclose(a.audio, np.asarray(b.audio), atol=ATOL)
    assert pm.last_run == {"prompt_len": len(ids), "chunks": 1, "steps": 32,
                           "tokens": 32}


def test_stop_token_ends_generation_as_jax(models):
    """With the stop the id greedy decoding draws fifth, both packages
    stop there, the stop and every later step dropped."""
    jm, pm, _ = models
    ids = _FakeTok().encode(pm.preprocess_text(TEXT)[0])
    free, _ = pm.decode_tokens(ids, 24, 0.0, 0.95, 0)
    stop = free[4]
    pm._stop_token_id = stop
    try:
        got, rows = pm.decode_tokens(ids, 24, 0.0, 0.95, 0)
    finally:
        pm._stop_token_id = 2
    want, jrows = jax_decode(jm, ids, 24, stop)
    assert got == want == free[:free.index(stop)]
    np.testing.assert_allclose(rows[0].numpy(), jrows, atol=ATOL)
    assert pm.last_run["chunks"] == 1


def test_jax_runs_past_max_tokens_the_port_stops(models):
    """A fault of the JAX package: `generate` keeps every kept token of
    whole 32-step chunks, so max_tokens 16 yields 32. The port stops at
    16, its tokens JAX's first 16."""
    jm, pm, _ = models
    (b,) = list(jm.generate(TEXT, max_tokens=16, temperature=0.0))
    (a,) = list(pm.generate(TEXT, max_tokens=16, temperature=0.0))
    assert b.token_count == 32 and a.token_count == 16
    ids = _FakeTok().encode(pm.preprocess_text(TEXT)[0])
    jt, jr = jax_decode(jm, ids, 16)
    pt, pr = pm.decode_tokens(ids, 16, 0.0, 0.95, 0)
    assert len(jt) == 32 and pt == jt[:16]
    np.testing.assert_allclose(pr[0].numpy(), jr[:17], atol=ATOL)
    assert pm.last_run["steps"] == 16


def test_jax_cache_clamps_the_port_holds_the_request(models):
    """A fault of the JAX package: its caches hold bucket + max_tokens
    columns, so a 64-id prompt (its bucket) with max_tokens 8 writes the
    chunk's later steps onto earlier columns, and the rows after step 8
    differ from the same request's with room (max_tokens 64). The port's
    8 rows equal JAX's with room."""
    jm, pm, _ = models
    ids = LongTok().encode(pm.preprocess_text(" ".join([TEXT] * 2))[0])[:64]
    assert len(ids) == 64
    roomy_t, roomy_r = jax_decode(jm, ids, 64)
    tight_t, tight_r = jax_decode(jm, ids, 8)
    assert len(tight_t) == 32
    assert not np.allclose(tight_r[9:33], roomy_r[9:33], atol=1e-3)
    np.testing.assert_allclose(tight_r[:9], roomy_r[:9], atol=ATOL)
    pt, pr = pm.decode_tokens(ids, 8, 0.0, 0.95, 0)
    assert pt == roomy_t[:8]
    np.testing.assert_allclose(pr[0].numpy(), roomy_r[:9], atol=ATOL)


def test_sampled_decode_is_seeded_and_stops(models):
    _, pm, _ = models
    ids = _FakeTok().encode(pm.preprocess_text(TEXT)[0])
    a, _ = pm.decode_tokens(ids, 40, 0.8, 0.9, 3)
    b, _ = pm.decode_tokens(ids, 40, 0.8, 0.9, 3)
    c, _ = pm.decode_tokens(ids, 40, 0.8, 0.9, 4)
    assert a == b and a != c and len(a) <= 40
    assert pm.last_run["steps"] <= 40


def test_generate_needs_a_tokenizer(models):
    from mlx_audio_tpu_torch.tts.models.soprano import Model

    m = Model(CFG, device="cpu")
    with pytest.raises(RuntimeError, match="tokenizer"):
        list(m.generate("hello"))


# ---------------------------------------------------------------------------
# loading
# ---------------------------------------------------------------------------


def test_sanitize_equals_jax_on_the_jax_tests_keys(models):
    """tests/test_soprano.py's checkpoint (a torch depthwise (C, 1, K) and
    embed conv): both packages' trees; the prefixes."""
    jm, pm, _ = models
    w = {"model.embed_tokens.weight": np.ones((64, 16), np.float32),
         "decoder.decoder.convnext.0.dwconv.weight":
             np.arange(48, dtype=np.float32).reshape(16, 1, 3),
         "decoder.decoder.embed.weight":
             np.arange(256, dtype=np.float32).reshape(16, 16, 1),
         "language_model.norm.weight": np.ones((16,), np.float32)}
    a, b = pm.sanitize(w), jm.sanitize(w)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], np.asarray(b[k]))
    assert a["decoder.decoder.convnext.0.dwconv.weight"].shape == (3, 1, 16)


def test_sanitize_reads_mlx_convs_where_jax_misreads(models):
    """A fault of the JAX package: its `sanitize` takes a conv weight for
    torch's when its first axis is the longer, so an MLX depthwise (C, K,
    1) becomes (1, K, C) and an MLX embed conv (O, K, I) is left as it is.
    The port reads each from the model's shapes."""
    jm, pm, flat = models
    dw = flat["decoder.decoder.convnext.0.dwconv.weight"]       # (3, 1, 16)
    emb = flat["decoder.decoder.embed.weight"]                  # (1, 16, 16)
    mlx = {"decoder.decoder.convnext.0.dwconv.weight": dw.transpose(2, 0, 1),
           "decoder.decoder.embed.weight": emb.transpose(2, 0, 1)}
    got, want = pm.sanitize(mlx), jm.sanitize(mlx)
    for k, v in got.items():
        np.testing.assert_array_equal(v, flat[k])
    assert np.shape(want["decoder.decoder.convnext.0.dwconv.weight"]) == \
        (1, 3, 16)
    assert not np.array_equal(np.asarray(
        want["decoder.decoder.embed.weight"]), emb)


def test_post_load_hook_raises_where_jax_swallows(tmp_path, monkeypatch):
    """Without tokenizer files there is no tokenizer; files that fail to
    load raise, where JAX's hook leaves no tokenizer on any error."""
    from mlx_audio_tpu.tts.models.soprano import Model as JModel
    from mlx_audio_tpu_torch.tts.models.soprano import Model

    m = Model(CFG, device="cpu")
    assert Model.post_load_hook(m, tmp_path)._tokenizer is None

    def broken(path, **kw):
        raise OSError(f"cannot read the tokenizer in {path}")

    fake = types.ModuleType("transformers")
    fake.AutoTokenizer = types.SimpleNamespace(from_pretrained=broken)
    monkeypatch.setitem(sys.modules, "transformers", fake)
    (tmp_path / "tokenizer.json").write_text("{broken")
    with pytest.raises(OSError, match="tokenizer"):
        Model.post_load_hook(m, tmp_path)
    jm = JModel(CFG)
    assert JModel.post_load_hook(jm, tmp_path)._tokenizer is None

    class Tok(_FakeTok):
        pad_token_id = None

        def encode(self, text, add_special_tokens=False):
            return [7] if text == "[STOP]" else super().encode(text)

    fake.AutoTokenizer = types.SimpleNamespace(
        from_pretrained=lambda path, **kw: Tok())
    assert Model.post_load_hook(m, tmp_path)._stop_token_id == 7


def test_load_model_from_a_directory(models, tmp_path):
    """A Soprano directory (config.json, the JAX tree in npz) through the
    top-level `load_model` on the CPU generates what the bound model does;
    the card is the default."""
    from mlx_audio_tpu_torch.utils import load_model

    _, pm, flat = models
    d = tmp_path / "soprano-1.1-tiny"
    d.mkdir()
    (d / "config.json").write_text(json.dumps(dict(CFG,
                                                   model_type="soprano")))
    np.savez(d / "model.npz", **flat)
    m = load_model(str(d), device="cpu")
    assert type(m).__module__.endswith("soprano.soprano")
    m._tokenizer, m._stop_token_id = _FakeTok(), 2
    (a,) = list(m.generate(TEXT, max_tokens=8, temperature=0.0))
    (b,) = list(pm.generate(TEXT, max_tokens=8, temperature=0.0))
    np.testing.assert_array_equal(a.audio, b.audio)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            load_model(str(d))


def test_tts_cli_writes_a_directorys_audio(models, tmp_path, monkeypatch):
    """The TTS CLI (`main`, --device cpu) on a Soprano directory (the
    stand-in tokenizer as the directory's): the WAV of the directory's
    model's own greedy generate()."""
    from mlx_audio_tpu_torch import audio_io
    from mlx_audio_tpu_torch.tts.generate import main
    from mlx_audio_tpu_torch.tts.models.soprano import soprano
    from mlx_audio_tpu_torch.tts.utils import load_model

    _, _, flat = models
    d = tmp_path / "soprano-1.1-tiny"
    d.mkdir()
    (d / "config.json").write_text(json.dumps(dict(CFG,
                                                   model_type="soprano")))
    np.savez(d / "model.npz", **flat)
    monkeypatch.setattr(soprano, "local_tokenizer", lambda path: _FakeTok())
    main(["--model", str(d), "--text", TEXT, "--temperature", "0.0",
          "--max_tokens", "12", "--output_path", str(tmp_path / "out"),
          "--device", "cpu", "--no-verbose"])
    got, sr = audio_io.read(str(tmp_path / "out" / "audio_000.wav"),
                            dtype="float32")
    m = load_model(d, device="cpu")
    (want,) = list(m.generate(TEXT, max_tokens=12, temperature=0.0))
    assert sr == 16000 and len(got) == want.samples > 0
    np.testing.assert_allclose(got, np.clip(want.audio, -1, 1),
                               atol=2 / 32768)
