"""MOSS-TTS of the PyTorch port against the JAX package, on the CPU: the
cases of tests/test_moss_tts.py (the delay pattern, the three layouts'
prompts and decodes) and its GPT-2 local head, each held to the JAX
package's: the host copies' outputs equal (the text normalizer, the
delay pattern, the processors' rows of a text-only prompt, a cloned one
and a continuation, the config, sanitize); the GPT-2, the embeddings and
one LM step's logits within ATOL; greedy rows equal token for token in
each layout, and sampled rows equal with JAX's Gumbel draws fed through
the `_gumbel` seam; `generate` with a stand-in audio tokenizer bound to
both packages; then the faults of the JAX package and the port's
departures (the delay decode's stop at `max_new_tokens`, prompts past
4,096 rows, q8 of the local layouts, the stream, a strict
`post_load_hook`) and the loader.

Config: tests/test_moss_tts.py's tiny layouts (a 2-layer Qwen3 LM at d32
with its 151,700 ids, 4 channels of 24 codes; the v1.5 GPT-2 one layer
at d32; the legacy local stack one layer at d32) and its CharTok, with
the pad code at 24, inside the 25-row channel tables (the JAX test's
default pad code, 1024, indexes past its tables); one parameter set a
layout drawn with numpy over JAX's shapes (`test_torch_mimi.
numpy_params`), with one weight moved so that the greedy decode stops
within the test's frames: the delay text head's <|im_end|> row doubled,
the v1.5 GPT-2's `ln_f` bias 3.0 on its first channel, the legacy text
head's <audio_end> row times 4. ATOL = 2e-4 (f32, summation order)."""

import contextlib
import dataclasses
import json
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_moss_tts import LANG, CharTok  # noqa: E402
from test_torch_mimi import flat_numpy, numpy_params  # noqa: E402

ATOL = 2e-4
BASE = dict(language_config=LANG, n_vq=4, audio_vocab_size=24,
            audio_pad_token_id=24)
GPT2 = dict(vocab_size=64, n_embd=32, n_layer=1, n_head=4, n_inner=64)
LAYOUTS = {
    "delay": dict(BASE, model_type="moss_tts_delay"),
    "v15": dict(BASE, model_type="moss_tts_local",
                audio_codebook_sizes=[24] * 4, gpt2_config=GPT2),
    "legacy": dict(BASE, model_type="moss_tts",
                   additional_mlp_ffn_hidden_size=48,
                   local_ffn_hidden_size=48, local_hidden_size=32,
                   local_num_layers=1),
}
TEXTS = ["hello world", "# Title\n- a [x](http://u.io/x) and @me",
         "你好 world 123！！", "Wait... what?! -- fine → ok",
         "【标题】正文内容。", "e-mail me at a.b@c.org or see r/moss"]
REF = np.random.RandomState(0).randint(0, 24, size=(6, 4))


class StandInCodec:
    """A stand-in MOSS audio tokenizer, bound to both packages: codes of
    an audio's 1,920-sample frames, and a sine a frame for codes."""

    spf = 1920

    def __init__(self):
        self.decoded = []

    def encode_audio(self, audio, sample_rate=None, num_quantizers=4):
        a = np.asarray(audio, np.float32).reshape(-1)
        n = max(1, len(a) // self.spf)
        x = np.resize(a, n * self.spf).reshape(n, self.spf)
        return (np.abs(x[:, :7 * num_quantizers:7]) * 997).astype(
            np.int64) % 24

    def decode_audio_codes(self, codes, num_quantizers=4):
        c = np.asarray(codes, np.int64)
        self.decoded.append(len(c))
        t = np.arange(self.spf)
        return np.concatenate([0.1 * np.sin(t * 1e-3 * (1 + r.sum()))
                               for r in c]).astype(np.float32)


def _moved(layout: str, flat: dict) -> dict:
    flat = dict(flat)
    if layout == "delay":
        w = flat["text_lm_head.weight"].copy()
        w[151645] *= 2.0
        flat["text_lm_head.weight"] = w
    elif layout == "v15":
        b = flat["local_transformer.ln_f.bias"].copy()
        b[0] = 3.0
        flat["local_transformer.ln_f.bias"] = b
    else:
        w = flat["text_lm_head.weight"].copy()
        w[151653] *= 4.0
        flat["text_lm_head.weight"] = w
    return flat


def _pair(layout: str, flat=None, cfg=None):
    from mlx_audio_tpu.tts.models.moss_tts import Model as JModel
    from mlx_audio_tpu.tts.models.moss_tts import ModelConfig as JConfig
    from mlx_audio_tpu.utils import unflatten
    from mlx_audio_tpu_torch.model import load_jax_params
    from mlx_audio_tpu_torch.tts.models.moss_tts import Model

    cfg = cfg or LAYOUTS[layout]
    jm = JModel(JConfig.from_dict(cfg))
    if flat is None:
        flat = _moved(layout, flat_numpy(numpy_params(jm.init_params, 0)))
    jm.bind(unflatten({k: jnp.asarray(v) for k, v in flat.items()}))
    pm = load_jax_params(Model(cfg, device="cpu"), flat)
    for m in (jm, pm):
        m.tokenizer = CharTok()
        m.audio_tokenizer = StandInCodec()
    return jm, pm, flat


@pytest.fixture(scope="module")
def models():
    """{layout: (JAX model, port model, the flat tree)}, built on first
    use."""
    cache = {}

    def get(layout):
        if layout not in cache:
            cache[layout] = _pair(layout)
        return cache[layout]

    return get


def _prompt(model, kind: str) -> np.ndarray:
    proc = model._processor()
    if kind == "text":
        conv, mode = [proc.build_user_message(text="hello")], "generation"
    elif kind == "clone":
        conv = [proc.build_user_message(text="hi", reference=[REF])]
        mode = "generation"
    else:
        conv = [proc.build_user_message(text="hello"),
                proc.build_assistant_message([REF])]
        mode = "continuation"
    return proc([conv], mode=mode)["input_ids"]


# ---------------------------------------------------------------------------
# draws
# ---------------------------------------------------------------------------


def delay_draws(model, seed: int, n: int) -> dict:
    """JAX's delay-pattern Gumbel noise for n frames: each frame splits its
    key in three, the text draw from the second, the audio from the
    third."""
    cfg = model.config
    key, out = jax.random.PRNGKey(seed), {"text": [], "audio": []}
    for _ in range(n):
        key, k1, k2 = jax.random.split(key, 3)
        out["text"].append(jax.random.gumbel(
            k1, (1, cfg.language_config.vocab_size), jnp.float32))
        out["audio"].append(jax.random.gumbel(
            k2, (cfg.n_vq, cfg.audio_vocab_size + 1), jnp.float32))
    return out


def local_draws(model, seed: int, n: int) -> dict:
    """JAX's local-layout Gumbel noise for n frames: one key split a draw,
    the text draw first (v1.5: over the two candidates), then one a
    channel."""
    cfg = model.config
    v15 = cfg.is_v15_local_transformer
    text = (1, 2) if v15 else (1, cfg.language_config.vocab_size)
    audio = (1, 24) if v15 else (1, cfg.audio_vocab_size + 1)
    key, out = jax.random.PRNGKey(seed), {"text": [], "audio": []}
    for _ in range(n):
        for kind, shape in [("text", text)] + [("audio", audio)] * cfg.n_vq:
            key, sub = jax.random.split(key)
            out[kind].append(jax.random.gumbel(sub, shape, jnp.float32))
    return out


@contextlib.contextmanager
def fed(model, draws: dict):
    """`model` drawing `draws` (by kind, in order) through its `_gumbel`
    seam."""
    its = {k: iter(v) for k, v in draws.items()}

    def gumbel(kind, shape, generator):
        g = np.asarray(next(its[kind]))
        assert g.shape == tuple(shape), (kind, g.shape, shape)
        return torch.from_numpy(np.array(g))

    model._gumbel = gumbel
    try:
        yield model
    finally:
        del model._gumbel


def _ids(model, rows, layout, n, **kw):
    if layout == "delay":
        return model.generate_delay_pattern_ids(rows, max_new_tokens=n, **kw)
    if layout == "v15":
        return model.generate_v15_local_ids(rows, max_new_tokens=n, **kw)
    return model.generate_local_ids(rows, max_new_tokens=n, **kw)


GREEDY = {"delay": dict(text_temperature=0.0, audio_temperature=0.0),
          "v15": dict(do_sample=False),
          "legacy": dict(text_temperature=0.0, audio_temperature=0.0)}


# ---------------------------------------------------------------------------
# the host copies
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("text", TEXTS)
def test_text_normalizer_copy_equals_jax(text):
    from mlx_audio_tpu.tts.models.moss_tts.text import normalize_tts_text \
        as jn
    from mlx_audio_tpu_torch.tts.models.moss_tts.text import \
        normalize_tts_text as pn

    assert pn(text) == jn(text)
    assert pn(None) is None


def test_delay_pattern_equals_jax():
    from mlx_audio_tpu.tts.models.moss_tts import processor as jp
    from mlx_audio_tpu_torch.tts.models.moss_tts import processor as pp

    codes = np.arange(24).reshape(6, 4)
    d = pp.apply_delay_pattern(codes, 99)
    np.testing.assert_array_equal(d, jp.apply_delay_pattern(codes, 99))
    assert d.shape == (9, 4) and d[0, 1] == 99
    np.testing.assert_array_equal(pp.apply_de_delay_pattern(d), codes)
    assert pp.apply_de_delay_pattern(np.zeros((2, 4))).shape == (0, 4)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("kind", ["text", "clone", "continuation"])
def test_processor_rows_equal_jax(models, layout, kind):
    jm, pm, _ = models(layout)
    want = _prompt(jm, kind)
    got = _prompt(pm, kind)
    np.testing.assert_array_equal(got, want)
    if kind == "text" and layout != "v15":
        assert (got[0, :, 1:] == 24).all()


def test_config_equals_jax():
    from mlx_audio_tpu.tts.models.moss_tts import ModelConfig as JConfig
    from mlx_audio_tpu_torch.tts.models.moss_tts import ModelConfig

    for cfg in list(LAYOUTS.values()) + [dict(
            qwen3_config=dict(hidden_size=64, num_attention_heads=4,
                              rope_parameters={"rope_theta": 5.0}),
            audio_assistant_gen_slot_token_id=7, sample_rate=16000)]:
        a, b = ModelConfig.from_dict(cfg), JConfig.from_dict(cfg)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        for p in ("is_legacy_local_transformer", "is_v15_local_transformer",
                  "is_local_transformer", "hidden_size", "vocab_size"):
            assert getattr(a, p) == getattr(b, p)
        if a.is_legacy_local_transformer:
            assert dataclasses.asdict(a.local_transformer_config()) == \
                dataclasses.asdict(b.local_transformer_config())
        if a.is_v15_local_transformer:
            assert dataclasses.asdict(a.local_gpt2_config()) == \
                dataclasses.asdict(b.local_gpt2_config())


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_sanitize_equals_jax(models, layout):
    """Upstream names of each layout: the per-channel tables and heads
    stacked as JAX's."""
    jm, pm, _ = models(layout)
    rng = np.random.RandomState(1)
    d = 32
    if layout == "delay":
        w = {f"model.emb_ext.{c}.weight": rng.randn(25, d) for c in range(4)}
        w.update({f"model.lm_heads.{i}.weight": rng.randn(25, d)
                  for i in range(5)})
        w["model.language_model.norm.weight"] = rng.randn(d)
    elif layout == "v15":
        w = {f"audio_embeddings.{c}.weight": rng.randn(24, d)
             for c in range(4)}
        w.update({f"audio_lm_heads.{c}.weight": rng.randn(24, d)
                  for c in range(4)})
        w["transformer.norm.weight"] = rng.randn(d)
    else:
        w = {f"model.embedding_list.{i}.weight": rng.randn(25, d)
             for i in range(5)}
        w.update({f"lm_heads.{i}.weight": rng.randn(25, d)
                  for i in range(5)})
        w["local_transformer.norm.weight"] = rng.randn(d)
    w = {k: v.astype(np.float32) for k, v in w.items()}
    a, b = pm.sanitize(w), jm.sanitize(w)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], np.asarray(b[k]))


# ---------------------------------------------------------------------------
# the modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("act,pos", [("gelu_new", "rope"),
                                     ("gelu", "absolute"), ("silu", "rope")])
def test_gpt2_equals_jax(act, pos):
    """The GPT-2 over 5 rows without a cache, and the same rows one a
    step through the port's cache, within ATOL of JAX's uncached run."""
    from mlx_audio_tpu.tts.models.moss_tts_nano import gpt2 as jg
    from mlx_audio_tpu.utils import unflatten
    from mlx_audio_tpu_torch.model import load_jax_params
    from mlx_audio_tpu_torch.model import TorchModel
    from mlx_audio_tpu_torch.tts.models.moss_tts_nano import gpt2 as pg

    kw = dict(GPT2, n_layer=2, activation_function=act,
              position_embedding_type=pos, n_positions=16)
    jc, pc = jg.GPT2Config(**kw), pg.GPT2Config(**kw)
    flat = flat_numpy(numpy_params(
        lambda k: jg.init_gpt2(k, jc, use_token_embedding=False), 2))
    holder = TorchModel(pc)
    holder.g = pg.init_gpt2(pc, use_token_embedding=False, device="cpu")
    load_jax_params(holder, {f"g.{k}": v for k, v in flat.items()})
    x = np.random.RandomState(3).randn(1, 5, 32).astype(np.float32)
    want, _ = jax.jit(lambda p, e: jg.gpt2_forward(p, jc, e))(
        unflatten({k: jnp.asarray(v) for k, v in flat.items()}),
        jnp.asarray(x))
    with torch.inference_mode():
        got, _ = pg.gpt2_forward(holder.g, torch.from_numpy(x))
        caches = pg.gpt2_make_caches(pc, 1, 5)
        steps = [pg.gpt2_forward(holder.g, torch.from_numpy(x[:, i:i + 1]),
                                 caches=caches, offset=i)[0]
                 for i in range(5)]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(),
                               np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_embeddings_equal_jax(models, layout):
    jm, pm, _ = models(layout)
    rows = _prompt(pm, "continuation")
    fn = {"delay": "_embed_rows_delay", "v15": "_embed_rows_v15",
          "legacy": "_embed_rows_legacy"}[layout]
    want = jax.jit(lambda p, r: getattr(jm, fn)(p, r))(
        jm.params, jnp.asarray(rows, jnp.int32))
    with torch.inference_mode():
        got = getattr(pm, fn)(torch.from_numpy(rows))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_lm_step_logits_equal_jax(models, layout):
    """The prompt through the LM, then one step of its last row: the text
    head's and the audio heads' logits of that step within ATOL."""
    from mlx_audio_tpu.tts.models.moss_tts.moss_tts import (
        _make_lm_caches, qwen3_lm_forward as jfwd)
    from mlx_audio_tpu_torch.tts.models.moss_tts.moss_tts import \
        qwen3_lm_forward

    jm, pm, _ = models(layout)
    rows = _prompt(pm, "continuation")
    plen = rows.shape[1]
    lc = jm.config.language_config
    embed = {"delay": jm._embed_rows_delay, "v15": jm._embed_rows_v15,
             "legacy": jm._embed_rows_legacy}[layout]
    lmp = {"delay": lambda p: p["language_model"],
           "v15": lambda p: p["transformer"],
           "legacy": lambda p: p["model"]["language_model"]}[layout]

    def jax_step(p, r):
        caches = _make_lm_caches(lc, 1, plen + 1)
        _, caches = jfwd(lmp(p), lc, embed(p, r[:, :-1]), caches, 0)
        h, _ = jfwd(lmp(p), lc, embed(p, r[:, -1:]), caches, plen - 1)
        h = h[:, -1]
        return (h @ p["text_lm_head"]["weight"].T,
                h @ p["audio_lm_heads"]["weight"].T)

    want = jax.jit(jax_step)(jm.params, jnp.asarray(rows, jnp.int32))
    pembed = {"delay": pm._embed_rows_delay, "v15": pm._embed_rows_v15,
              "legacy": pm._embed_rows_legacy}[layout]
    with torch.inference_mode():
        r = torch.from_numpy(rows)
        caches = pm.lm().make_caches(pm.config.language_config, 1, plen + 1)
        qwen3_lm_forward(pm.lm(), pembed(r[:, :-1]), caches, 0)
        h = pm._lm_step(pembed(r[:, -1:]), caches, plen - 1)
        got = (pm.text_lm_head(h), pm.audio_lm_heads(h))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


# ---------------------------------------------------------------------------
# the decodes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("kind", ["text", "continuation"])
def test_greedy_rows_equal_jax(models, layout, kind):
    """Greedy rows token for token (JAX's delay decode keeps whole chunks:
    its rows are compared up to the port's max_new_tokens)."""
    jm, pm, _ = models(layout)
    rows = _prompt(pm, kind)
    (sj, gj), = _ids(jm, rows, layout, 12, **GREEDY[layout])
    (sp, gp), = _ids(pm, rows, layout, 12, **GREEDY[layout])
    assert sp == sj
    np.testing.assert_array_equal(gp, gj[:len(gp)])
    if layout != "delay":
        assert len(gp) == len(gj)
    assert pm.last_run["frames"] <= 12


def test_greedy_decodes_reach_their_stops(models):
    """The moved weights make each layout's greedy decode stop inside the
    frames compared: the delay's <|im_end|> after its delay and
    <audio_end>, the v1.5 end token, the legacy <audio_end>."""
    for layout, want in (("delay", 7), ("v15", 4), ("legacy", 11)):
        _, pm, _ = models(layout)
        out = _ids(pm, _prompt(pm, "continuation"), layout, 16,
                   **GREEDY[layout])
        assert pm.last_run["frames"] == want, (layout, pm.last_run)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_sampled_rows_equal_jax(models, layout):
    """Sampled rows (the JAX decodes' default knobs, repetition penalties
    1.3 on) equal JAX's with its Gumbel draws fed through `_gumbel`."""
    jm, pm, _ = models(layout)
    rows = _prompt(pm, "continuation")
    kw = dict(seed=3, audio_repetition_penalty=1.3)
    if layout == "legacy":
        kw["text_repetition_penalty"] = 1.3
    (sj, gj), = _ids(jm, rows, layout, 8, **kw)
    draws = (delay_draws if layout == "delay" else local_draws)(
        pm, 3, 8 + 8)
    with fed(pm, draws):
        (sp, gp), = _ids(pm, rows, layout, 8, **kw)
    assert sp == sj
    np.testing.assert_array_equal(gp, gj[:len(gp)])


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_generate_equals_jax(models, layout):
    """`generate` greedy through the stand-in tokenizer: cloned from a
    reference audio (encoded by the codec) in the delay and v1.5 layouts,
    a continuation of its codes in the legacy one: the same audio and
    token count as JAX's."""
    jm, pm, _ = models(layout)
    ref = np.sin(np.arange(6 * 1920) * 0.01).astype(np.float32)
    kw = dict(GREEDY[layout], max_tokens=12, ref_audio=ref)
    if layout == "legacy":
        kw.update(mode="continuation", ref_text="hi ")
    if layout == "v15":
        kw.update(mode="continuation")
    (a,) = list(pm.generate("hello", **kw))
    (b,) = list(jm.generate("hello", **kw))
    assert a.token_count == b.token_count and a.sample_rate == 24000
    np.testing.assert_array_equal(a.audio, np.asarray(b.audio))


def test_generate_needs_a_tokenizer_and_a_codec(models):
    from mlx_audio_tpu_torch.tts.models.moss_tts import Model, ModelConfig

    _, pm, _ = models("delay")
    m = Model(LAYOUTS["delay"], device="cpu")
    with pytest.raises(ValueError, match="Tokenizer"):
        list(m.generate("hi"))
    m.tokenizer = CharTok()
    with pytest.raises(RuntimeError, match="audio tokenizer"):
        list(m.generate("hi", ref_audio=np.zeros(1920, np.float32)))
    with pytest.raises(NotImplementedError, match="v1.5"):
        list(pm.generate("hi", stream=True))
    with pytest.raises(ValueError, match="language_config"):
        Model(ModelConfig(), device="cpu")


# ---------------------------------------------------------------------------
# faults of the JAX package and the port's departures
# ---------------------------------------------------------------------------


def test_jax_delay_runs_past_max_new_tokens_the_port_stops(models):
    """A fault of the JAX package: its delay decode keeps whole chunks of
    8 frames, so max_new_tokens 3 yields the whole first chunk (7 rows
    here, where <|im_end|> ends it). The port yields 3, equal to JAX's
    first 3."""
    jm, pm, _ = models("delay")
    rows = _prompt(pm, "continuation")
    (_, gj), = _ids(jm, rows, "delay", 3, **GREEDY["delay"])
    (_, gp), = _ids(pm, rows, "delay", 3, **GREEDY["delay"])
    prompt = len(gp) - pm.last_run["frames"]
    assert pm.last_run["frames"] == 3 and len(gj) - prompt == 7
    np.testing.assert_array_equal(gp, gj[:len(gp)])


def test_jax_fails_past_4096_prompt_rows_the_port_runs(models):
    """A fault of the JAX package: its prompt bucket caps at 4,096 rows,
    so a 4,100-row prompt fails to fit (:598). The port runs the prompt
    unpadded (here a one-layer LM, to keep the test short) and raises only
    where its cache would pass MAX_CACHE_LEN."""
    from mlx_audio_tpu_torch.tts.models.moss_tts.moss_tts import \
        MAX_CACHE_LEN

    from mlx_audio_tpu_torch.tts.models.moss_tts import Model

    jm, pm, _ = models("delay")
    rows = _prompt(pm, "text")
    rows = np.concatenate([np.repeat(rows[:, :1], 4100 - rows.shape[1], 1),
                           rows], axis=1)
    assert rows.shape[1] == 4100
    with pytest.raises(ValueError):
        jm.generate_delay_pattern_ids(rows, max_new_tokens=2,
                                      **GREEDY["delay"])
    one = Model(dict(LAYOUTS["delay"], language_config=dict(
        LANG, num_hidden_layers=1)), device="cpu").init_params(seed=0)
    (_, g), = one.generate_delay_pattern_ids(rows, max_new_tokens=2,
                                             **GREEDY["delay"])
    assert one.last_run["frames"] == 2 and g.shape[1] == 5
    with pytest.raises(ValueError, match="cache"):
        pm.generate_delay_pattern_ids(rows, max_new_tokens=MAX_CACHE_LEN)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_q8_runs_on_the_quantized_heads(models, layout):
    """q8 at group 16: the port quantizes the linears JAX's rule does (not
    `audio_embeddings`). JAX's local frames reshape
    `audio_lm_heads.weight`, a leaf its q8 has quantized, and fail
    (KeyError 'weight'; its delay frame runs the leaf as a linear). The
    port runs each channel's rows of the quantized head; its greedy rows
    equal JAX's with the port's quantized weights dequantized (the plain
    version's products)."""
    import copy

    from mlx_audio_tpu.tts.models.moss_tts import Model as JModel
    from mlx_audio_tpu.tts.models.moss_tts import ModelConfig as JConfig
    from mlx_audio_tpu.tts.models.moss_tts.moss_tts import (HISTORY_WIN,
                                                            _make_lm_caches)
    from mlx_audio_tpu.utils import apply_quantization, flatten, unflatten
    from mlx_audio_tpu_torch.nn import QuantizedLinear
    from mlx_audio_tpu_torch.utils import apply_quantization as papply
    from test_torch_tada import dequantized_flat

    jm, pm, flat = models(layout)
    q = {"quantization": {"group_size": 16, "bits": 8}}
    shapes = jax.eval_shape(lambda t: apply_quantization(
        t, q, model_quant_predicate=jm.model_quant_predicate), unflatten(
            {k: jnp.asarray(v) for k, v in flat.items()}))
    jkeys = {k[:-len(".w_q")] for k in flatten(shapes) if k.endswith(".w_q")}
    rows = _prompt(pm, "continuation")
    if layout != "delay":
        jq = JModel(JConfig.from_dict(LAYOUTS[layout]))
        cfg, lc = jq.config, jq.config.language_config
        args = (_make_lm_caches(lc, 1, 8), 0, jnp.zeros((1, 1, 32)))
        hist = jnp.full((cfg.n_vq, HISTORY_WIN), -1, jnp.int32)
        if layout == "v15":
            frame = jq._v15_frame_fn(False, 1.0, 1.0, 50, 1.7, 0.8, 25, 1.0)
            args += (hist,)
        else:
            frame = jq._legacy_frame_fn(cfg.n_vq, 0.0, 1.0, 50, 1.0, 0.0,
                                        0.95, 50, 1.1)
            args += (jnp.full((HISTORY_WIN,), -1, jnp.int32), hist)
        with pytest.raises(KeyError, match="weight"):
            frame.lower(shapes, *args, jax.random.PRNGKey(0))
    pq = copy.deepcopy(pm)
    papply(pq, q, pq.model_quant_predicate)
    held = {n for n, m in pq.named_modules()
            if isinstance(m, QuantizedLinear)}
    assert held == jkeys and "audio_lm_heads" in held
    assert not any("audio_embeddings" in k for k in held)
    jm.bind(unflatten({k: jnp.asarray(v) for k, v in
                       dequantized_flat(flat, pq).items()}))
    try:
        (sj, gj), = _ids(jm, rows, layout, 5, **GREEDY[layout])
    finally:
        jm.bind(unflatten({k: jnp.asarray(v) for k, v in flat.items()}))
    (sp, gp), = _ids(pq, rows, layout, 5, **GREEDY[layout])
    assert sp == sj
    np.testing.assert_array_equal(gp, gj[:len(gp)])


def test_stream_yields_each_chunk_as_it_is_decoded(models):
    """A fault of the JAX package: `_stream_v15` gathers every chunk and
    yields them after the last frame. The port's stream gives the same
    chunks in the same order, and its first arrives while frames remain
    to be generated."""
    jm, pm, _ = models("v15")
    kw = dict(do_sample=False, max_tokens=12, streaming_interval=0.32,
              streaming_context_frames=2)
    it = pm.generate("hello", stream=True, **kw)
    first = next(it)
    frames_then = pm.last_run["frames"]
    got = [first] + list(it)
    want = list(jm.generate("hello", stream=True, **kw))
    assert pm.last_run["frames"] == 12 and frames_then < 12
    assert [r.token_count for r in got] == [r.token_count for r in want]
    assert [r.is_final_chunk for r in got] == \
        [r.is_final_chunk for r in want]
    assert len(got) >= 3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.audio, np.asarray(b.audio))


def test_post_load_hook_raises_where_jax_swallows(tmp_path, monkeypatch):
    """Without tokenizer files there is no tokenizer, and the directory's
    generation_config.json is read; files that fail to load raise, where
    JAX's hook leaves no tokenizer (and an empty config) on any error."""
    from mlx_audio_tpu.tts.models.moss_tts import Model as JModel
    from mlx_audio_tpu.tts.models.moss_tts import ModelConfig as JConfig
    from mlx_audio_tpu_torch.tts.models.moss_tts import Model

    def broken(path, **kw):
        raise OSError(f"cannot read the tokenizer in {path}")

    fake = types.ModuleType("transformers")
    fake.AutoTokenizer = types.SimpleNamespace(from_pretrained=broken)
    monkeypatch.setitem(sys.modules, "transformers", fake)
    m = Model(LAYOUTS["delay"], device="cpu")
    jm = JModel(JConfig.from_dict(LAYOUTS["delay"]))
    (tmp_path / "generation_config.json").write_text(
        json.dumps({"max_new_tokens": 9, "temperature": None}))
    assert Model.post_load_hook(m, tmp_path).tokenizer is None
    assert m._gc("max_new_tokens", 4096) == 9
    assert m._gc("temperature", 1.7) == 1.7
    (tmp_path / "generation_config.json").write_text("{broken")
    with pytest.raises(json.JSONDecodeError):
        Model.post_load_hook(m, tmp_path)
    assert JModel.post_load_hook(jm, tmp_path).generation_config == {}
    (tmp_path / "generation_config.json").unlink()
    (tmp_path / "tokenizer.json").write_text("{broken")
    with pytest.raises(OSError, match="tokenizer"):
        Model.post_load_hook(m, tmp_path)
    assert JModel.post_load_hook(jm, tmp_path).tokenizer is None


# ---------------------------------------------------------------------------
# the loader
# ---------------------------------------------------------------------------


def _upstream(layout: str, flat: dict) -> dict:
    """The JAX tree with v1.5's stacked tables split into the upstream
    per-channel names that `sanitize` stacks (JAX's reads no other)."""
    if layout != "v15":
        return flat
    out = dict(flat)
    for name in ("audio_embeddings", "audio_lm_heads"):
        w = out.pop(f"{name}.weight")
        out.update({f"{name}.{c}.weight": w[24 * c:24 * (c + 1)]
                    for c in range(4)})
    return out


@pytest.mark.parametrize("layout,model_type", [
    ("delay", "moss_tts_delay"), ("delay", "moss_ttsd"),
    ("v15", "moss_tts_local"), ("legacy", "moss_tts")])
def test_load_model_from_a_directory(models, tmp_path, layout, model_type):
    """A MOSS-TTS directory (config.json, the JAX tree in npz; v1.5's
    channel tables under their upstream names) of each layout through the
    top-level `load_model` on the CPU decodes the bound model's rows; the
    card is the default."""
    from mlx_audio_tpu_torch.tts.models import moss_tts_delay, moss_tts_local
    from mlx_audio_tpu_torch.tts.models.moss_tts import Model
    from mlx_audio_tpu_torch.utils import load_model

    _, pm, flat = models(layout)
    assert moss_tts_delay.Model is moss_tts_local.Model is Model
    d = tmp_path / "moss-tiny"
    d.mkdir()
    (d / "config.json").write_text(json.dumps(dict(
        LAYOUTS[layout], model_type=model_type)))
    np.savez(d / "model.npz", **_upstream(layout, flat))
    m = load_model(str(d), device="cpu")
    assert type(m) is Model
    m.tokenizer = CharTok()
    rows = _prompt(pm, "text")
    a = _ids(m, rows, layout, 6, **GREEDY[layout])[0][1]
    b = _ids(pm, rows, layout, 6, **GREEDY[layout])[0][1]
    np.testing.assert_array_equal(a, b)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            load_model(str(d))
