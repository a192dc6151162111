"""OmniVoice of the PyTorch port against the JAX package, on the CPU: the
cases of tests/test_omnivoice.py (the text helpers, the duration
estimator, the silence tools, the backbone's logits, the iterative
unmask, mixed-length batches, voice-clone tokens, sanitize), each held to
the JAX package's: the host copies' outputs equal, the logits within
ATOL, the revealed codes equal with JAX's Gumbel uniforms fed through the
`_draws` seam; then the faults the slice meets (the out-of-range gather,
the batch without a mask, silence without a codec, a hook that warns),
the loader and the server's speech route.

Config: tests/test_omnivoice.py's tiny OmniVoice (a 2-layer backbone at
d32, 4 codebooks of 17, 200 text ids) and its FakeTok, one parameter set
drawn with numpy over JAX's shapes (`test_torch_mimi.numpy_params`); the
codec is chip_smoke.py's small Higgs codec (4 books of 64). ATOL = 2e-4
(f32, summation order)."""

import asyncio
import contextlib
import dataclasses
import io
import json
import sys
import types
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_omnivoice import FakeTok, _cfg  # noqa: E402
from test_torch_mimi import flat_numpy, numpy_params  # noqa: E402

ATOL = 2e-4
TEXTS = ["hello world", "你 好 世界", "hi [laughter] there [sigh]",
         "line\r\none\t\ttwo", "[question-en]", "12 apples, 3 pears!"]


@pytest.fixture(scope="module")
def models():
    """(JAX OmniVoice, port OmniVoice, the flat tree) on one weight set,
    each with FakeTok; the port's with the small Higgs codec."""
    from chip_smoke import HIGGS_CODEC_SMALL
    from mlx_audio_tpu.tts.models.omnivoice import Model as JModel
    from mlx_audio_tpu.utils import unflatten
    from mlx_audio_tpu_torch.codec.models.higgs_audio import Model as Codec
    from mlx_audio_tpu_torch.model import load_jax_params
    from mlx_audio_tpu_torch.tts.models.omnivoice import Model

    jm = JModel(_cfg())
    flat = flat_numpy(numpy_params(jm.init_params, 0))
    jm.bind(unflatten({k: jnp.asarray(v) for k, v in flat.items()}))
    pm = load_jax_params(Model(dataclasses.asdict(_cfg()), device="cpu"),
                         flat)
    jm.text_tokenizer, pm.text_tokenizer = FakeTok(), FakeTok()
    pm.audio_tokenizer = Codec(HIGGS_CODEC_SMALL,
                               device="cpu").init_params(seed=1)
    return jm, pm, flat


def jax_uniforms(seed, steps, shape, ct, pt):
    """The uniforms JAX's unmask draws: a split of its key into three a
    step, the class noise from the second (when class_temperature > 0),
    the position noise from the third (when position_temperature > 0)."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(steps):
        key, k1, k2 = jax.random.split(key, 3)
        if ct > 0:
            out.append(np.asarray(jax.random.uniform(k1, shape + (17,))))
        if pt > 0:
            out.append(np.asarray(jax.random.uniform(k2, shape)))
    return out


@contextlib.contextmanager
def feed(pm, draws):
    """`pm` drawing `draws` in order through its `_draws` seam."""
    it = iter(draws)
    pm._draws = lambda shape, generator: torch.from_numpy(
        np.array(next(it))).reshape(shape)
    try:
        yield pm
    finally:
        del pm._draws


def rows_for(pm, texts, durations, refs=None):
    rows, tls = [], []
    for i, (t, d) in enumerate(zip(texts, durations)):
        ref = None if refs is None else refs[i]
        s, x = pm._tokenize_style_and_text(t, denoise=ref is not None)
        tl = pm._target_len(t, d)
        tls.append(tl)
        rows.append(pm._prepare_inputs(s, x, tl, ref))
    return rows, tls


# ---------------------------------------------------------------------------
# host copies
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("text", TEXTS)
def test_text_helpers_equal_jax(models, text):
    from mlx_audio_tpu.tts.models.omnivoice import omnivoice as jo
    from mlx_audio_tpu_torch.tts.models.omnivoice import omnivoice as po

    jm, pm, _ = models
    for ref in (None, "a reference"):
        assert po.combine_text(text, ref) == jo.combine_text(text, ref)
    assert po.tokenize_with_nonverbal_tags(text, FakeTok()) == \
        jo.tokenize_with_nonverbal_tags(text, FakeTok())
    for dur in (None, 0.4, 3.0):
        assert pm._target_len(text, dur) == jm._target_len(text, dur)
    s = pm._tokenize_style_and_text(text, "English", "calm", True, "ref")
    assert s == jm._tokenize_style_and_text(text, "English", "calm", True,
                                            "ref")
    a = pm._prepare_inputs(*s, 7, np.ones((3, 4), np.int32))
    b = jm._prepare_inputs(*s, 7, np.ones((3, 4), np.int32))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_duration_estimator_copy_equals_jax():
    from mlx_audio_tpu.tts.models.omnivoice.duration import \
        RuleDurationEstimator as J
    from mlx_audio_tpu_torch.tts.models.omnivoice.duration import \
        RuleDurationEstimator as P

    p, j = P(), J()
    texts = ["你好世界" * 8, "abcd" * 8, "a", "Привет мир", "مرحبا",
             "안녕하세요", "こんにちは", "١٢٣ 123 ...", "é", ""]
    for t in texts:
        for low in (None, 50):
            assert p.estimate_duration(t, "Nice to meet you.", 25, low) == \
                j.estimate_duration(t, "Nice to meet you.", 25, low)
    assert p.estimate_duration("a", "", 25) == 0.0


@pytest.mark.parametrize("seed", [0, 1])
def test_silence_tools_copy_equal_jax(seed):
    from mlx_audio_tpu.tts.models.omnivoice import utils as ju
    from mlx_audio_tpu_torch.tts.models.omnivoice import utils as pu

    sr = 1000
    rng = np.random.RandomState(seed)
    a = (rng.randn(6000) * 1e-4).astype(np.float32)
    a[500:1000] = 0.5
    a[3000 + 100 * seed:3500] = 0.3
    for kw in (dict(min_silence_len=200, silence_thresh=-40),
               dict(min_silence_len=100, silence_thresh=-50, seek_step=10)):
        assert pu.detect_silent_ranges_ms(a, sr, **kw) == \
            ju.detect_silent_ranges_ms(a, sr, **kw)
        assert pu.detect_nonsilent_ranges_ms(a, sr, **kw) == \
            ju.detect_nonsilent_ranges_ms(a, sr, **kw)
    np.testing.assert_array_equal(pu.remove_silence(a, sr, mid_sil=300),
                                  ju.remove_silence(a, sr, mid_sil=300))
    long = np.tile(a, 5)
    np.testing.assert_array_equal(
        pu.trim_long_audio(long, sr, 15.0, 20.0),
        ju.trim_long_audio(long, sr, 15.0, 20.0))


# ---------------------------------------------------------------------------
# the backbone and the unmask
# ---------------------------------------------------------------------------


def test_forward_equals_jax_with_text_ids_past_the_audio_tables(models):
    """JAX's `_forward` looks the text ids (3-42 here, against 17-row
    audio tables) up in the audio tables too: `jnp.take` fills those rows
    with NaN and the `where` drops them. The port clamps the lookup; the
    logits are JAX's."""
    jm, pm, _ = models
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 17, (2, 9, 4))
    ids[:, :4] = rng.randint(17, 200, (2, 4, 1))
    mask = np.zeros((2, 9), bool)
    mask[:, 4:] = True
    raw = np.asarray(jnp.take(jm.params["audio_embeddings"]["0"]["weight"],
                              jnp.asarray(ids[..., 0]), axis=0))
    assert np.isnan(raw[:, :4]).all() and np.isfinite(raw[:, 4:]).all()
    want = np.asarray(jax.jit(jm._forward)(jm.params, jnp.asarray(ids),
                                           jnp.asarray(mask)))
    with torch.inference_mode():
        got = pm._forward(torch.from_numpy(ids), torch.from_numpy(mask))
    assert got.shape == (2, 9, 4, 17) and np.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("case", [
    dict(g=2.0, ct=0.0, pt=5.0, steps=4),
    dict(g=2.0, ct=1.0, pt=5.0, steps=3),
    dict(g=0.0, ct=0.0, pt=0.0, steps=3),
    dict(g=1.5, ct=0.5, pt=0.0, steps=2, ref=True)])
def test_unmask_reveals_what_jax_reveals(models, case):
    """One row (its style, text and, with `ref`, 5 voice-clone frames):
    the revealed codes with JAX's uniforms fed, CFG on and off, class and
    position noise on and off."""
    jm, pm, _ = models
    refs = [np.random.RandomState(0).randint(0, 16, (5, 4))] \
        if case.get("ref") else None
    rows, tls = rows_for(pm, ["hello world"], [0.4], refs)
    args = (rows, tls, case["steps"], case["g"], case["ct"], case["pt"],
            5.0, 0.1, 0)
    want = jm._run_unmask(*args)
    with feed(pm, jax_uniforms(0, case["steps"], (1, tls[0], 4), case["ct"],
                               case["pt"])):
        got = pm._run_unmask(*args)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].shape == (10, 4) and pm.last_run["steps"] == case["steps"]


def test_ties_at_the_threshold_reveal_what_jax_reveals(models):
    """Heads of zeros make every confidence equal: each step's threshold
    ties every still-masked slot, and both packages reveal them all at
    the first step."""
    from mlx_audio_tpu.tts.models.omnivoice import Model as JModel
    from mlx_audio_tpu.utils import unflatten

    jm, pm, flat = models
    tree = {k: (np.zeros_like(v) if k.startswith("audio_heads") else v)
            for k, v in flat.items()}
    jz = JModel(_cfg())
    jz.bind(unflatten({k: jnp.asarray(v) for k, v in tree.items()}))
    heads = [getattr(pm.audio_heads, str(i)).weight for i in range(4)]
    saved = [w.clone() for w in heads]
    rows, tls = rows_for(pm, ["hi"], [0.4])
    try:
        for w in heads:
            w.zero_()
        got = pm._run_unmask(rows, tls, 3, 2.0, 0.0, 0.0, 0.0, 0.1, 0)
    finally:
        for w, s in zip(heads, saved):
            w.copy_(s)
    want = jz._run_unmask(rows, tls, 3, 2.0, 0.0, 0.0, 0.0, 0.1, 0)
    np.testing.assert_array_equal(got[0], want[0])


def test_jax_batch_attends_to_padding_the_port_masks_it(models):
    """A fault of the JAX package: its backbone has no attention mask, so
    the shorter row of a mixed-length batch attends to the padding (mask
    ids) in both passes, and its codes differ from the row's alone. The
    port masks the padded keys: a batched row equals the row alone, and
    a batch of rows of one length equals JAX's (noise off: the draws'
    shapes follow the batch)."""
    jm, pm, _ = models
    args = (3, 2.0, 0.0, 0.0, 5.0, 0.1, 0)
    rows, tls = rows_for(pm, ["one", "two two"], [0.4, 0.8])
    jb, pb = jm._run_unmask(rows, tls, *args), pm._run_unmask(rows, tls,
                                                              *args)
    j0 = jm._run_unmask(rows[:1], tls[:1], *args)
    p0 = pm._run_unmask(rows[:1], tls[:1], *args)
    np.testing.assert_array_equal(p0[0], j0[0])
    assert not np.array_equal(jb[0], j0[0])
    np.testing.assert_array_equal(pb[0], p0[0])
    np.testing.assert_array_equal(pb[1], jb[1])
    same, tls2 = rows_for(pm, ["one", "two"], [0.8, 0.8])
    for a, b in zip(pm._run_unmask(same, tls2, *args),
                    jm._run_unmask(same, tls2, *args)):
        np.testing.assert_array_equal(a, b)


def test_generate_batch_decodes_through_the_codec(models):
    """The port's results: the revealed codes through the Higgs codec,
    the JAX package's counts and lengths (tests/test_omnivoice.py)."""
    jm, pm, _ = models
    texts, durs = ["one", "two two"], [0.4, 0.8]
    res = pm.generate_batch(texts, duration_s=durs, num_steps=3, seed=0,
                            position_temperature=0.0)
    rows, tls = rows_for(pm, texts, durs)
    toks = pm._run_unmask(rows, tls, 3, 2.0, 0.0, 0.0, 5.0, 0.1, 0)
    assert [r.token_count for r in res] == [10, 20]
    assert [r.segment_idx for r in res] == [0, 1]
    for r, t in zip(res, toks):
        assert r.samples == r.token_count * 960
        np.testing.assert_array_equal(r.audio,
                                      pm.audio_tokenizer.decode(t))
    (g,) = list(pm.generate("hi", duration_s=0.4, num_steps=3,
                            ref_tokens=np.ones((5, 4), np.int64), seed=0))
    assert g.token_count == 10 and np.isfinite(g.audio).all()


def test_no_codec_raises_where_jax_returns_silence(models):
    from mlx_audio_tpu_torch.tts.models.omnivoice import Model

    jm, _, flat = models
    (b,) = list(jm.generate("hi", duration_s=0.4, num_steps=2, seed=0))
    assert not np.asarray(b.audio).any()
    m = Model(dataclasses.asdict(_cfg()), device="cpu")
    m.text_tokenizer = FakeTok()
    with pytest.raises(RuntimeError, match="codec"):
        list(m.generate("hi", duration_s=0.4))


# ---------------------------------------------------------------------------
# loading and serving
# ---------------------------------------------------------------------------


def test_sanitize_equals_jax(models):
    """The stacked tables and heads split into the codebooks', `llm.` ->
    `backbone.`, the offsets dropped."""
    jm, pm, _ = models
    rng = np.random.RandomState(0)
    w = {"llm.embed_tokens.weight": rng.randn(200, 32),
         "llm.layers.0.self_attn.q_norm.weight": rng.randn(8),
         "audio_embeddings.weight": rng.randn(4 * 17, 32),
         "audio_heads.weight": rng.randn(4 * 17, 32),
         "codebook_layer_offsets": np.arange(4)}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    a, b = pm.sanitize(w), jm.sanitize(w)
    assert sorted(a) == sorted(b) and "codebook_layer_offsets" not in a
    for k in a:
        np.testing.assert_array_equal(a[k], np.asarray(b[k]))
    assert a["audio_heads.3.weight"].shape == (17, 32)


def _write_dir(d, flat, codec):
    d.mkdir()
    (d / "config.json").write_text(json.dumps(dict(
        dataclasses.asdict(_cfg()), model_type="omnivoice")))
    np.savez(d / "model.npz", **flat)
    if codec is not None:
        from chip_smoke import HIGGS_CODEC_SMALL

        (d / "audio_tokenizer").mkdir()
        (d / "audio_tokenizer" / "config.json").write_text(json.dumps(
            dict(HIGGS_CODEC_SMALL, model_type="higgs_audio_v2_tokenizer")))
        np.savez(d / "audio_tokenizer" / "model.npz",
                 **{k: v.numpy() for k, v in codec.state_dict().items()})


def test_post_load_hook_reads_the_directory_strictly(models, tmp_path,
                                                     monkeypatch):
    """The Higgs codec of `audio_tokenizer/` is bound; tokenizer files
    that fail to load raise. JAX's hook warns where its tokenizer fails,
    and loads its codec from the model directory itself, non-strictly: a
    codec with no weights."""
    from mlx_audio_tpu.tts.models.omnivoice import Model as JModel
    from mlx_audio_tpu.utils import flatten
    from mlx_audio_tpu_torch.tts.models.omnivoice import Model

    _, pm, flat = models
    d = tmp_path / "omnivoice-tiny"
    _write_dir(d, flat, pm.audio_tokenizer)
    m = Model(dataclasses.asdict(_cfg()), device="cpu")
    Model.post_load_hook(m, d)
    assert m.text_tokenizer is None
    codes = np.random.RandomState(0).randint(0, 16, (6, 4))
    np.testing.assert_array_equal(m.audio_tokenizer.decode(codes),
                                  pm.audio_tokenizer.decode(codes))
    jm = JModel(_cfg())
    monkeypatch.setitem(sys.modules, "transformers", None)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        JModel.post_load_hook(jm, d)
    assert jm.text_tokenizer is None and len(caught) == 1
    # JAX's codec: the model directory's weights, of which its sanitize
    # keeps none, bound without a check; it cannot decode
    assert not flatten(jm.audio_tokenizer.params)
    with pytest.raises(Exception):
        jm.audio_tokenizer.decode(codes)

    def broken(path, **kw):
        raise OSError(f"cannot read the tokenizer in {path}")

    fake = types.ModuleType("transformers")
    fake.AutoTokenizer = types.SimpleNamespace(from_pretrained=broken)
    monkeypatch.setitem(sys.modules, "transformers", fake)
    (d / "tokenizer.json").write_text("{broken")
    with pytest.raises(OSError, match="tokenizer"):
        Model.post_load_hook(m, d)


def test_speech_route_serves_a_directory(models, tmp_path, monkeypatch):
    """A tiny OmniVoice directory (its codec in audio_tokenizer/, the
    stand-in tokenizer) through the top-level loader and the server's
    /v1/audio/speech: the WAV of the directory's model's own generate();
    the card is the loader's default."""
    from mlx_audio_tpu_torch import audio_io
    from mlx_audio_tpu_torch.server import AudioServer
    from mlx_audio_tpu_torch.tts.models.omnivoice import omnivoice
    from mlx_audio_tpu_torch.utils import load_model

    _, pm, flat = models
    d = tmp_path / "omnivoice-tiny"
    _write_dir(d, flat, pm.audio_tokenizer)
    monkeypatch.setattr(omnivoice, "local_tokenizer",
                        lambda path, **kw: FakeTok())

    async def go():
        server = AudioServer(device="cpu")
        try:
            reply = await server.speech({"model": str(d),
                                         "input": "hello world"})
            return reply.status, await reply.read()
        finally:
            server.close()

    status, body = asyncio.run(go())
    assert status == 200
    got, sr = audio_io.read(io.BytesIO(body), dtype="float32")
    model = load_model(str(d), device="cpu")
    assert type(model).__module__.endswith("omnivoice.omnivoice")
    (want,) = list(model.generate("hello world"))
    assert sr == 24000 and len(got) == len(want.audio) > 0
    np.testing.assert_allclose(got, np.clip(want.audio, -1, 1),
                               atol=2 / 32768)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            load_model(str(d))


def test_voice_clone_prompt_equals_jax(models, tmp_path):
    """`create_voice_clone_prompt` on a 16-kHz WAV (resampled to 24 kHz,
    the RMS boost, the long-audio trim, the silence removal) hands the
    codec the JAX package's samples, and `generate(ref_audio=path)` runs
    through it with the stand-in codec's codes."""
    from mlx_audio_tpu.tts.models.omnivoice.utils import \
        create_voice_clone_prompt as jcreate
    from mlx_audio_tpu_torch import audio_io
    from mlx_audio_tpu_torch.tts.models.omnivoice.utils import \
        create_voice_clone_prompt

    class Seen:
        def __init__(self):
            self.got = []

        def encode(self, wav):
            self.got.append(np.asarray(wav))
            return np.arange(12, dtype=np.int32).reshape(3, 4) % 16

    sr = 16000
    rng = np.random.RandomState(3)
    x = (rng.randn(sr * 2) * 1e-3).astype(np.float32)
    x[4000:12000] += 0.05 * np.sin(np.arange(8000) / 9.0).astype(np.float32)
    path = tmp_path / "ref.wav"
    audio_io.write(str(path), x, sr)
    a, b = Seen(), Seen()
    for ref_text in (None, "some words"):
        np.testing.assert_array_equal(
            create_voice_clone_prompt(str(path), a, ref_text),
            jcreate(str(path), b, ref_text))
    for got, want in zip(a.got, b.got):
        np.testing.assert_allclose(got, want, atol=1e-6)
    _, pm, _ = models
    codec, pm.audio_tokenizer = pm.audio_tokenizer, None
    try:
        with pytest.raises(RuntimeError, match="codec"):
            list(pm.generate("hi", duration_s=0.4, ref_audio=str(path)))
        stand_in = Seen()
        stand_in.decode = codec.decode
        pm.audio_tokenizer = stand_in
        (r,) = list(pm.generate("hi", duration_s=0.4, num_steps=2,
                                ref_audio=str(path)))
    finally:
        pm.audio_tokenizer = codec
    assert r.token_count == 10 and len(stand_in.got) == 1
