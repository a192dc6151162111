"""TADA of the PyTorch port against the JAX package, on the CPU: the cases
of tests/test_tada.py (the gray code, the schedules, the text cleanup, the
segment masks, the alignment, the four generation modes), each held to
the JAX package's: the host copies' outputs equal; the flow head, one AR
step's latent and the codec decoder within ATOL; the latents within ATOL
and the durations equal with JAX's draws fed through the `_draws` seam,
and the audio within ATOL, for zero-shot, cloned, two-pass and no-CFG
requests; then the departures (the codec decodes the rows it has, any
length; the cache's limit; q8 keeps the tables dense; a strict
`post_load_hook`), sanitize, the loader, the TTS CLI and the server.

Config: tests/test_tada.py's tiny TADA (a 2-layer llama at d32, a 2-block
head, a codec at d24 with strides [2, 2]) and its stand-in tokenizer, one
parameter set drawn with numpy over JAX's shapes
(`test_torch_mimi.numpy_params`; the snake alphas set to 1-1.5, where
numpy_params leaves them 0 and the snake passes x through). JAX decodes
its latents at an exact bucket (`LATENT_BUCKETS` patched) wherever the
audio is compared whole; `test_jax_bucket_padding_reaches_the_last_
samples` compares its own buckets. ATOL = 2e-4 (f32, summation order)."""

import asyncio
import contextlib
import dataclasses
import io
import json
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_mimi import flat_numpy, numpy_params  # noqa: E402

ATOL = 2e-4
FM = 4
CFG = dict(
    vocab_size=300, hidden_size=32, num_hidden_layers=2,
    num_attention_heads=4, num_key_value_heads=2, head_dim=8,
    intermediate_size=64, acoustic_dim=16, num_time_classes=16,
    shift_acoustic=2, head_layers=2, head_ffn_ratio=2.0,
    decoder_hidden_dim=24, decoder_d_model=4, decoder_embed_dim=16,
    decoder_strides=[2, 2], decoder_num_attn_layers=1,
    decoder_num_attn_heads=4, decoder_attn_dim_feedforward=48,
    encoder_hidden_dim=24, encoder_embed_dim=16, encoder_strides=[2, 2],
    encoder_num_attn_layers=1, encoder_num_attn_heads=4,
    encoder_attn_dim_feedforward=48)
TEXTS = ['he said: "yes" -- ok…', "Hello (there); it's “fine” — really!",
         "a. b? c! d", "«quoted» ‘single’ text–dash", ""]
EXACT = tuple(range(1, 8193))


class Tok:
    """tests/test_tada.py's stand-in tokenizer."""

    bos_token_id = 1

    def encode(self, s, **kwargs):
        return [10 + (ord(c) % 200) for c in s]

    def convert_tokens_to_ids(self, t):
        return {"<|eot_id|>": 5, "<|start_header_id|>": 6,
                "<|end_header_id|>": 7,
                "<|finetune_right_pad_id|>": 8}.get(t, 9)


def _alphas(flat: dict, seed: int) -> dict:
    rng = np.random.RandomState(seed)
    return {k: (1.0 + 0.5 * rng.rand(*v.shape)).astype(np.float32)
            if k.endswith(".alpha") else v for k, v in flat.items()}


def _jit_jax_encoder():
    """The JAX package's codec encoder runs its stack eagerly, op by op
    (`_encoder_forward`, :530-554); its two stacks jitted here (the same
    functions, compiled once)."""
    from mlx_audio_tpu.tts.models.tada import tada as jt

    if getattr(jt.wav_encoder_forward, "jitted", False):
        return
    wav, attn = jt.wav_encoder_forward, jt.local_attention_forward
    j_wav = jax.jit(lambda p, x, strides: wav(p, list(strides), x),
                    static_argnums=2)
    j_attn = jax.jit(lambda p, x, mask, heads: attn(p, x, heads, mask=mask),
                     static_argnums=3)

    def wav_jit(p, strides, x):
        return j_wav(p, x, tuple(strides))

    def attn_jit(p, x, heads, mask=None):
        return j_attn(p, x, mask, heads)

    wav_jit.jitted = True
    jt.wav_encoder_forward, jt.local_attention_forward = wav_jit, attn_jit


@pytest.fixture(scope="module")
def models():
    """(JAX TADA, port TADA, the flat tree, the encoder's flat tree) on
    one weight set, each with the stand-in tokenizer and the same codec
    encoder."""
    from mlx_audio_tpu.tts.models.tada import Model as JModel
    from mlx_audio_tpu.tts.models.tada import ModelConfig as JConfig
    from mlx_audio_tpu.utils import unflatten
    from mlx_audio_tpu_torch.model import load_jax_params
    from mlx_audio_tpu_torch.tts.models.tada import Model
    from mlx_audio_tpu_torch.tts.models.tada.tada import CodecEncoder

    _jit_jax_encoder()
    jm = JModel(JConfig(**CFG))
    flat = _alphas(flat_numpy(numpy_params(jm.init_params, 0)), 0)
    jm.bind(unflatten({k: jnp.asarray(v) for k, v in flat.items()}))
    enc = _alphas(flat_numpy(numpy_params(jm.init_encoder_params, 1)), 1)
    jm._encoder_params = unflatten({k: jnp.asarray(v)
                                    for k, v in enc.items()})
    pm = load_jax_params(Model(CFG, device="cpu"), flat)
    pm.set_encoder(load_jax_params(CodecEncoder(pm.config, device="cpu"),
                                   enc))
    jm._tokenizer, pm._tokenizer = Tok(), Tok()
    return jm, pm, flat, enc


@pytest.fixture
def exact_buckets(monkeypatch):
    from mlx_audio_tpu.tts.models.tada import tada as jt

    monkeypatch.setattr(jt, "LATENT_BUCKETS", EXACT)


def jax_draws(seed: int, n: int, size: int) -> list:
    """The noise JAX's loop draws for its first n steps: each step's flow
    splits the loop's key and draws from the sub-key."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, (1, size),
                                                jnp.float32)))
    return out


@contextlib.contextmanager
def fed(model, draws):
    """`model` drawing `draws` in order through its `_draws` seam."""
    it = iter(draws)
    model._draws = lambda generator: torch.from_numpy(np.array(next(it)))
    try:
        yield model
    finally:
        del model._draws


def capture(model):
    """Record the (latents, durations) each `decode_wav` of `model` is
    given."""
    seen = []
    inner = model.decode_wav

    def dec(encoded, times):
        seen.append((np.asarray(encoded).copy(), np.asarray(times).copy()))
        return inner(encoded, times)

    model.decode_wav = dec
    return seen


def _steps(pm, text, ref_text=None, max_tokens=1024) -> int:
    from mlx_audio_tpu_torch.tts.models.tada.tada import normalize_text

    full = ("" if ref_text is None else normalize_text(ref_text)) + \
        normalize_text(text)
    return min(len(pm._prompt_ids(full)[0]), max_tokens)


# ---------------------------------------------------------------------------
# the host copies
# ---------------------------------------------------------------------------


def test_gray_code_equals_jax():
    from mlx_audio_tpu.tts.models.tada import tada as jt
    from mlx_audio_tpu_torch.tts.models.tada import tada as pt

    for bits in (4, 8):
        for n in range(2 ** bits):
            g = pt.int_to_gray_bits(n, bits)
            assert g == jt.int_to_gray_bits(n, bits)
            assert pt.gray_bits_to_int(g) == jt.gray_bits_to_int(g) == n
            dev = pt.gray_bits_to_int_device(torch.tensor(g) * 0.3)
            assert int(dev) == n


@pytest.mark.parametrize("text", TEXTS)
def test_normalize_text_equals_jax(text):
    from mlx_audio_tpu.tts.models.tada import tada as jt
    from mlx_audio_tpu_torch.tts.models.tada import tada as pt

    assert pt.normalize_text(text) == jt.normalize_text(text)


@pytest.mark.parametrize("sched", ["cosine", "logsnr", "linear"])
def test_schedules_equal_jax(sched):
    from mlx_audio_tpu.tts.models.tada import tada as jt
    from mlx_audio_tpu_torch.tts.models.tada import tada as pt

    for n in (4, 8, 20):
        np.testing.assert_array_equal(pt.build_time_schedule(n, sched),
                                      jt.build_time_schedule(n, sched))
    for t in (0.0, 0.3, 1.0):
        for base in (1.0, 1.6):
            assert pt.scheduled_cfg(base, t, sched) == \
                jt.scheduled_cfg(base, t, sched)
    assert pt.scheduled_cfg(1.6, 0.5, "constant") == 1.6


def test_align_and_segment_masks_equal_jax():
    from mlx_audio_tpu.tts.models.tada import codec as jc
    from mlx_audio_tpu.tts.models.tada import tada as jt
    from mlx_audio_tpu_torch.tts.models.tada import codec as pc
    from mlx_audio_tpu_torch.tts.models.tada import tada as pt

    rng = np.random.RandomState(0)
    logits = rng.randn(50, 30).astype(np.float32)
    for toks in ([3, 7, 11, 19], [], [5] * 12):
        a = pt.align_text_tokens(logits, np.array(toks, np.int64), 24000,
                                 24000)
        b = jt.align_text_tokens(logits, np.array(toks, np.int64), 24000,
                                 24000)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    jmask = jax.jit(jc.segment_attention_mask, static_argnums=1)
    for tm in ([[0, 1, 0, 1, 0]], rng.randint(0, 2, (2, 9))):
        tm = np.asarray(tm, np.int32)
        for v in ("v1", "v2"):
            np.testing.assert_array_equal(
                pc.segment_attention_mask(torch.from_numpy(tm), v).numpy(),
                np.asarray(jmask(jnp.asarray(tm), v)))
    with pytest.raises(ValueError):
        pc.segment_attention_mask(torch.zeros(1, 2), "v3")


def test_config_equals_jax():
    from mlx_audio_tpu.tts.models.tada import ModelConfig as JConfig
    from mlx_audio_tpu_torch.tts.models.tada import ModelConfig

    for kw in ({}, CFG, dict(num_time_classes=100, bottleneck_dim=64)):
        a, b = ModelConfig.from_dict(kw), JConfig.from_dict(kw)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert (a.num_time_bits, a.time_dim, a.latent_size) == \
            (b.num_time_bits, b.time_dim, b.latent_size)
        la, lb = a.llama_config(), b.llama_config()
        for f in ("hidden_size", "num_hidden_layers", "intermediate_size",
                  "num_attention_heads", "num_key_value_heads",
                  "vocab_size", "rms_norm_eps", "rope_theta", "head_dim",
                  "tie_word_embeddings"):
            assert getattr(la, f) == getattr(lb, f)


# ---------------------------------------------------------------------------
# the modules
# ---------------------------------------------------------------------------


def test_flow_head_equals_jax(models):
    from mlx_audio_tpu.tts.models.tada import tada as jt
    from mlx_audio_tpu_torch.tts.models.tada import tada as pt

    jm, pm, _, _ = models
    rng = np.random.RandomState(3)
    c = pm.config
    x = rng.randn(3, c.latent_size).astype(np.float32)
    t = rng.rand(3).astype(np.float32)
    cond = rng.randn(3, c.hidden_size).astype(np.float32)
    want = jax.jit(lambda p, *a: jt.diffusion_head_forward(
        p, jm.config, *a))(jm.params["prediction_head"],
                           *map(jnp.asarray, (x, t, cond)))
    with torch.inference_mode():
        got = pt.diffusion_head_forward(pm.prediction_head, c,
                                        *map(torch.from_numpy, (x, t, cond)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("acoustic_cfg", [1.6, 1.0])
def test_one_step_latent_equals_jax(models, acoustic_cfg):
    """The first AR step (the llama step of the positive and, under CFG,
    the negative stream, then the whole flow) from JAX's draw: its latent
    within ATOL of JAX's compiled step's (the one its `generate` runs)."""
    from mlx_audio_tpu.ops.kvcache import KVCache as JCache
    from mlx_audio_tpu.tts.models.tada import tada as jt
    from mlx_audio_tpu_torch.tts.models.llama.llama import init_caches

    jm, pm, _, _ = models
    c = pm.config
    need_neg = acoustic_cfg != 1.0
    b = 2 if need_neg else 1
    lc = jm.config.llama_config()
    key = ("step", FM, acoustic_cfg, 1.0, "cosine", "logsnr", 0.9)
    if key not in jm._jit_cache:
        jm._jit_cache[key] = jm._step_fn(*key[1:])
    step = jm._jit_cache[key]
    caches = [JCache.init(b, jt.MAX_CACHE_LEN, lc.num_key_value_heads,
                          lc.resolved_head_dim, jnp.float32)
              for _ in range(lc.num_hidden_layers)]
    ids, neg = np.asarray([[1]], np.int32), np.asarray([[8]], np.int32)
    ac = np.random.RandomState(4).randn(1, 1, c.acoustic_dim).astype(
        np.float32)
    one = np.ones((1, 1), np.int32)
    _, want, _ = step(jm.params, caches, jnp.int32(0), jnp.asarray(ids),
                      jnp.asarray(neg), jnp.asarray(ac), jnp.asarray(one),
                      jnp.asarray(one * 3), jnp.asarray(one * 2),
                      jax.random.PRNGKey(0))
    (noise,) = jax_draws(0, 1, c.latent_size)
    plan = pm.flow_plan(FM, acoustic_cfg, 1.0, "cosine", "logsnr")
    tc = init_caches(pm.__dict__["_lm"].config, b, 8, torch.float32)
    ids_t = torch.tensor([[1], [8]]) if need_neg else torch.tensor([[1]])
    one_t = torch.ones((1, 1), dtype=torch.long)
    with torch.inference_mode():
        got = pm.step(tc, 0, ids_t, torch.from_numpy(ac), one_t, one_t * 3,
                      one_t * 2, torch.from_numpy(np.array(noise)) * 0.9, plan)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("n", [64, 102])
def test_codec_decoder_equals_jax(models, exact_buckets, n):
    """The codec decoder over n expanded rows (boundary rows among zero
    gaps, as `decode_wav` makes them): the port's samples within ATOL of
    JAX's decode at an exact bucket."""
    jm, pm, _, _ = models
    rng = np.random.RandomState(n)
    k = n // 4
    encoded = rng.randn(k, pm.config.acoustic_dim).astype(np.float32)
    times = np.full(k + 1, 4, np.int64)
    times[-1] = n - 4 * k
    want = jm.decode_wav(encoded, times)
    got = pm.decode_wav(encoded, times)
    assert got.shape == want.shape == (n * 4,)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_encoder_equals_jax(models):
    """The codec encoder of a reference (uniform alignment): the token
    values within ATOL, the positions and text equal."""
    jm, pm, _, _ = models
    ref = np.random.RandomState(0).randn(4800).astype(np.float32) * 0.1
    a = pm.encode_reference(ref, "prev words")
    b = jm.encode_reference(ref, "prev words")
    np.testing.assert_allclose(a[0], np.asarray(b[0]), atol=ATOL)
    np.testing.assert_array_equal(a[1], b[1])
    assert a[2] == b[2]


# ---------------------------------------------------------------------------
# generation
# ---------------------------------------------------------------------------

MODES = {
    "zero-shot": dict(text="hi there", max_tokens=16),
    "cloned": dict(text="more", ref_text="prev", max_tokens=20),
    "two-pass": dict(text="fast", max_tokens=12, speed_up_factor=1.5),
    "no-cfg": dict(text="plain", max_tokens=10, acoustic_cfg_scale=1.0),
}


def _bit_margin(pm, latents_j, times_p, times_j) -> str:
    return (f"durations {times_p.tolist()} vs JAX's {times_j.tolist()}; "
            f"the latents' smallest duration bit sits "
            f"{np.abs(latents_j).min():.2e} from 0")


@pytest.mark.parametrize("mode", list(MODES))
def test_generate_equals_jax(models, exact_buckets, mode):
    """The latents within ATOL and the durations equal with JAX's draws
    (a second pass draws JAX's again from the same seed), the audio within
    ATOL of JAX's at an exact bucket."""
    jm, pm, _, _ = models
    kw = dict(MODES[mode])
    text = kw.pop("text")
    ref = None
    if "ref_text" in kw:
        ref = np.random.RandomState(0).randn(4800).astype(np.float32) * 0.1
        kw["ref_audio"] = ref
    n = _steps(pm, text, kw.get("ref_text"), kw["max_tokens"])
    passes = 2 if "speed_up_factor" in kw else 1
    seen_j, seen_p = capture(jm), capture(pm)
    try:
        (b,) = list(jm.generate(text, num_flow_matching_steps=FM, **kw))
        with fed(pm, jax_draws(0, n, pm.config.latent_size) * passes):
            (a,) = list(pm.generate(text, num_flow_matching_steps=FM, **kw))
    finally:
        del jm.decode_wav, pm.decode_wav
    (enc_j, t_j), (enc_p, t_p) = seen_j[-1], seen_p[-1]
    assert np.array_equal(t_p, t_j), _bit_margin(pm, enc_j, t_p, t_j)
    np.testing.assert_allclose(enc_p, enc_j, atol=ATOL)
    assert a.samples == b.samples > 0 and a.token_count == b.token_count
    np.testing.assert_allclose(a.audio, np.asarray(b.audio), atol=ATOL)
    assert pm.last_run["steps"] == n
    assert pm.last_run["batch"] == (1 if mode == "no-cfg" else 2)


def test_generate_needs_a_tokenizer_and_an_encoder(models):
    from mlx_audio_tpu_torch.tts.models.tada import Model

    m = Model(CFG, device="cpu")
    with pytest.raises(RuntimeError, match="tokenizer"):
        list(m.generate("hi"))
    m._tokenizer = Tok()
    with pytest.raises(RuntimeError, match="encoder"):
        list(m.generate("hi", ref_audio=np.zeros(480, np.float32),
                        ref_text="a"))


# ---------------------------------------------------------------------------
# faults of the JAX package and the port's departures
# ---------------------------------------------------------------------------


def test_jax_bucket_padding_reaches_the_last_samples(models):
    """A fault of the JAX package: `decode_wav` pads the rows to a bucket
    (64 here, for 52 rows); attention masks the padded keys, but the
    padded rows' outputs are not zero and the decoder's convs are not
    causal, so JAX's last samples differ from an unpadded decode. The port
    decodes the rows it has and gives the unpadded samples."""
    from mlx_audio_tpu.tts.models.tada import tada as jt

    jm, pm, _, _ = models
    rng = np.random.RandomState(7)
    encoded = rng.randn(13, pm.config.acoustic_dim).astype(np.float32)
    times = np.full(14, 4, np.int64)
    times[-1] = 0
    padded = jm.decode_wav(encoded, times)
    jt.LATENT_BUCKETS, keep = EXACT, jt.LATENT_BUCKETS
    try:
        exact = jm.decode_wav(encoded, times)
    finally:
        jt.LATENT_BUCKETS = keep
    got = pm.decode_wav(encoded, times)
    assert padded.shape == exact.shape == got.shape == (52 * 4,)
    np.testing.assert_allclose(padded[:40], exact[:40], atol=ATOL)
    assert np.abs(padded[-20:] - exact[-20:]).max() > 1e-3
    np.testing.assert_allclose(got, exact, atol=ATOL)


def test_jax_fails_past_2048_rows_the_port_decodes(models):
    """A fault of the JAX package: `_bucket` caps at 2,048 latent rows
    (41 s at 50 Hz), so a longer track fails to fit `exp_b` (:466). The
    port decodes 2,750 rows."""
    jm, pm, _, _ = models
    encoded = np.random.RandomState(8).randn(10, pm.config.acoustic_dim) \
        .astype(np.float32)
    times = np.full(11, 250, np.int64)
    with pytest.raises(ValueError):
        jm.decode_wav(encoded, times)
    wav = pm.decode_wav(encoded, times)
    assert wav.shape == (2750 * 4,) and np.isfinite(wav).all()
    assert pm.last_run["latent_rows"] == 2750


def test_jax_cache_clamps_the_port_raises(models):
    """A fault of the JAX package: its llama caches hold 4,096 columns
    (MAX_CACHE_LEN), and its `dynamic_update_slice` writes past them land
    on the last columns (shown on a 4-column cache). The port raises
    before the loop for a request of more steps."""
    from mlx_audio_tpu.ops.kvcache import KVCache as JCache
    from mlx_audio_tpu.ops.kvcache import kv_update
    from mlx_audio_tpu.tts.models.tada import tada as jt
    from mlx_audio_tpu_torch.tts.models.tada import tada as pt

    assert jt.MAX_CACHE_LEN == pt.MAX_CACHE_LEN == 4096
    cache = JCache.init(1, 4, 1, 2, jnp.float32)
    new = jnp.ones((1, 1, 1, 2))
    cache = kv_update(cache, new, new, 4)
    assert float(cache.k[0, 3].sum()) == 2.0
    _, pm, _, _ = models
    ids = [1] + [10] * 4100
    with pytest.raises(ValueError, match="4096-column cache"):
        pm._run(ids, 2, None, None, 1.6, 1.0, "cosine", 0.9, FM, "logsnr",
                5, 5000, None, 0)


def dequantized_flat(flat: dict, model) -> dict:
    """`flat` with the weight of each of `model`'s affine-quantized
    linears replaced by its dequantized codes (the plain version's
    weight): the same tree, so a jitted JAX function does not compile
    again."""
    from mlx_audio_tpu_torch.nn import QuantizedLinear

    out = dict(flat)
    for name, m in model.named_modules():
        if isinstance(m, QuantizedLinear):
            n, k = m.w_q.shape
            g = m.w_q.float().reshape(n, m.scales.shape[1], -1)
            w = g * m.scales[..., None] + m.biases[..., None]
            out[name + ".weight"] = w.reshape(n, k).numpy()
    return out


def test_q8_keeps_the_tables_dense_where_jax_fails(models, tmp_path):
    """q8 at group 16: JAX's rule quantizes `acoustic_mask_emb`, a (2, D)
    table whose name has no "embed", and its step then fails to read it
    (KeyError 'weight'); it also quantizes each conv kernel whose output
    width the group divides (a 3-D leaf, here the codec's `conv_in`),
    which its codec could not read either. The port's directory quantizes
    the same linears but keeps every table and conv dense; its latents
    and durations equal JAX's with the port's quantized weights
    dequantized (the plain version's products)."""
    from mlx_audio_tpu.tts.models.tada import Model as JModel
    from mlx_audio_tpu.tts.models.tada import ModelConfig as JConfig
    from mlx_audio_tpu.utils import apply_quantization, flatten, unflatten
    from mlx_audio_tpu_torch.nn import Embedding, QuantizedLinear
    from mlx_audio_tpu_torch.utils import load_model

    jm, _, flat, _ = models
    q = {"quantization": {"group_size": 16, "bits": 8}}
    shapes = jax.eval_shape(lambda t: apply_quantization(t, q), unflatten(
        {k: jnp.asarray(v) for k, v in flat.items()}))
    tree = jax.tree.map(lambda x: jnp.zeros(x.shape, x.dtype), shapes)
    assert "w_q" in tree["acoustic_mask_emb"]
    jq = JModel(JConfig(**CFG))
    jq.bind(tree)
    jq._tokenizer = Tok()
    with pytest.raises(KeyError, match="weight"):
        list(jq.generate("hi", max_tokens=6, num_flow_matching_steps=FM))
    fq = flatten(shapes)
    jkeys = {k[:-len(".w_q")] for k in fq if k.endswith(".w_q")}
    dense = {k for k in jkeys
             if k == "acoustic_mask_emb" or len(fq[k + ".w_q"].shape) == 3}
    assert "decoder.wav_decoder.conv_in" in dense
    d = tmp_path / "tada-q8"
    d.mkdir()
    (d / "config.json").write_text(json.dumps(dict(CFG, model_type="tada",
                                                   **q)))
    np.savez(d / "model.npz", **flat)
    m = load_model(str(d), device="cpu")
    m._tokenizer = Tok()
    held = {n for n, x in m.named_modules() if isinstance(x, QuantizedLinear)}
    assert held == jkeys - dense and len(held) > 10
    assert isinstance(m.acoustic_mask_emb, Embedding)
    n = _steps(m, "hi there", max_tokens=10)
    seen_j, seen_p = capture(jm), capture(m)
    jm.bind(unflatten({k: jnp.asarray(v) for k, v in
                       dequantized_flat(flat, m).items()}))
    try:
        (b,) = list(jm.generate("hi there", max_tokens=10,
                                num_flow_matching_steps=FM))
        with fed(m, jax_draws(0, n, m.config.latent_size)):
            (a,) = list(m.generate("hi there", max_tokens=10,
                                   num_flow_matching_steps=FM))
    finally:
        del jm.decode_wav
        jm.bind(unflatten({k: jnp.asarray(v) for k, v in flat.items()}))
    (enc_j, t_j), (enc_p, t_p) = seen_j[-1], seen_p[-1]
    assert np.array_equal(t_p, t_j), _bit_margin(m, enc_j, t_p, t_j)
    np.testing.assert_allclose(enc_p, enc_j, atol=ATOL)
    assert a.samples == b.samples > 0 and np.isfinite(a.audio).all()


def test_post_load_hook_raises_where_jax_swallows(tmp_path, monkeypatch):
    """Without tokenizer files there is no tokenizer; files that fail to
    load raise, where JAX's hook leaves no tokenizer on any error."""
    from mlx_audio_tpu.tts.models.tada import Model as JModel
    from mlx_audio_tpu.tts.models.tada import ModelConfig as JConfig
    from mlx_audio_tpu_torch.tts.models.tada import Model

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
    jm = JModel(JConfig(**CFG))
    assert JModel.post_load_hook(jm, tmp_path)._tokenizer is None
    fake.AutoTokenizer = types.SimpleNamespace(
        from_pretrained=lambda path, **kw: Tok())
    assert isinstance(Model.post_load_hook(m, tmp_path)._tokenizer, Tok)


def test_sanitize_equals_jax(models):
    jm, pm, _, _ = models
    rng = np.random.RandomState(0)
    w = {"model.layers.0.self_attn.rotary_emb.inv_freq": rng.randn(4),
         "lm_head.weight": rng.randn(300, 32),
         "model.norm.weight": rng.randn(32),
         "acoustic_proj.weight": rng.randn(32, 16)}
    a, b = pm.sanitize(w), jm.sanitize(w)
    assert sorted(a) == sorted(b) == ["acoustic_proj.weight",
                                      "model.norm.weight"]
    for k in a:
        np.testing.assert_allclose(a[k], np.asarray(b[k]), rtol=1e-6)


# ---------------------------------------------------------------------------
# the loader, the CLI and the server
# ---------------------------------------------------------------------------


def _write_dir(path, flat, model_type="tada"):
    path.mkdir()
    cfg = dict(CFG, model_type=model_type)
    if model_type == "llama":
        cfg["acoustic_dim"] = CFG["acoustic_dim"]
    (path / "config.json").write_text(json.dumps(cfg))
    np.savez(path / "model.npz", **flat)
    return path


@pytest.mark.parametrize("model_type", ["tada", "llama"])
def test_load_model_from_a_directory(models, tmp_path, model_type):
    """A TADA directory (config.json, the JAX tree in npz; model_type
    "tada", or "llama" with `acoustic_dim`, JAX's rule) through the
    top-level `load_model` on the CPU generates what the bound model does;
    the card is the default."""
    from mlx_audio_tpu_torch.utils import load_model

    _, pm, flat, _ = models
    d = _write_dir(tmp_path / "tada-tiny", flat, model_type)
    m = load_model(str(d), device="cpu")
    assert type(m).__module__.endswith("tada.tada")
    m._tokenizer = Tok()
    outs = [list(x.generate("hi there", max_tokens=8,
                            num_flow_matching_steps=FM))[0].audio
            for x in (m, pm)]
    np.testing.assert_array_equal(*outs)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            load_model(str(d))


def test_tts_cli_writes_a_directorys_audio(models, tmp_path, monkeypatch):
    """The TTS CLI (`main`, --device cpu) on a TADA directory (the
    stand-in tokenizer as the directory's): the WAV of the directory's
    model's own generate()."""
    from mlx_audio_tpu_torch import audio_io
    from mlx_audio_tpu_torch.tts.generate import main
    from mlx_audio_tpu_torch.tts.models.tada import tada
    from mlx_audio_tpu_torch.tts.utils import load_model

    _, _, flat, _ = models
    d = _write_dir(tmp_path / "tada-tiny", flat)
    monkeypatch.setattr(tada, "local_tokenizer", lambda path: Tok())
    main(["--model", str(d), "--text", "hi there", "--max_tokens", "12",
          "--output_path", str(tmp_path / "out"), "--device", "cpu",
          "--no-verbose"])
    got, sr = audio_io.read(str(tmp_path / "out" / "audio_000.wav"),
                            dtype="float32")
    m = load_model(d, device="cpu")
    (want,) = list(m.generate("hi there", max_tokens=12))
    assert sr == 24000 and len(got) == want.samples > 0
    np.testing.assert_allclose(got, np.clip(want.audio, -1, 1),
                               atol=2 / 32768)


def test_speech_route_serves_a_directory(models, tmp_path, monkeypatch):
    """A tiny TADA directory through the server's /v1/audio/speech: the
    WAV of the directory's model's own generate()."""
    from mlx_audio_tpu_torch import audio_io
    from mlx_audio_tpu_torch.server import AudioServer
    from mlx_audio_tpu_torch.tts.models.tada import tada
    from mlx_audio_tpu_torch.utils import load_model

    _, _, flat, _ = models
    d = _write_dir(tmp_path / "tada-tiny", flat)
    monkeypatch.setattr(tada, "local_tokenizer", lambda path: Tok())

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
    (want,) = list(load_model(str(d), device="cpu").generate("hello world"))
    assert sr == 24000 and len(got) == len(want.audio) > 0
    np.testing.assert_allclose(got, np.clip(want.audio, -1, 1),
                               atol=2 / 32768)
