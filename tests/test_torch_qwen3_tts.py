"""Qwen3-TTS text ids -> audio in the PyTorch port against the JAX package,
on the CPU at float32.

Configs: `tests/test_qwen3_tts.py::tiny_cfg` with its tts special ids moved
inside the tiny text vocabulary (the defaults, ~151k, index past a 500-row
table: JAX's `take` then fills NaN where the port raises), and a variant
whose talker (48) is wider than its code predictor (32), so that
`small_to_mtp_projection` runs. The JAX model's random parameters reach the
port through `model.load_jax_params`, dense or quantized (bits 8, group 16,
as tests/test_qwen3_quantized.py).

Tolerances: ops and layer logits 2e-4 absolute at f32 (summation order
only; the repo's torch-parity precedent, tests/test_torch_parity.py:19);
codec audio 1e-4 relative (its values are ~1e-3 under random weights, so
an absolute bound says nothing). Greedy codes must be equal; they are
compared by decoding the port's codes with JAX's own decoder and holding
the result to JAX's generate() output at 1e-6 relative.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_qwen3_tts import tiny_cfg  # noqa: E402

ATOL = 2e-4
AUDIO_REL = 1e-4


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-30)


def _np(t):
    return t.detach().float().cpu().numpy()


def _jax_cfg(variant):
    from mlx_audio_tpu.tts.models.qwen3_tts import ModelConfig

    cfg = tiny_cfg()
    d = dataclasses.asdict(cfg)
    d.update(tts_bos_token_id=497, tts_eos_token_id=498, tts_pad_token_id=499)
    if variant == "wide":
        d["talker_config"].update(hidden_size=48, intermediate_size=96,
                                  text_hidden_size=40)
    return ModelConfig.from_dict(d)


_JAX = {}


def _jax_model(variant):
    """(JAX model, flat numpy params) per variant: 'tiny', 'wide', and
    their quantized forms 'tiny-q8', 'wide-q8'."""
    if variant not in _JAX:
        from mlx_audio_tpu.ops.quant import maybe_quantize_tree
        from mlx_audio_tpu.tts.models.qwen3_tts import Model
        from mlx_audio_tpu.utils import flatten

        base, _, q = variant.partition("-")
        jm = Model(_jax_cfg(base)).init_and_bind(jax.random.PRNGKey(
            1 if base == "wide" else 0))
        if base == "wide":
            # the published layout: the code predictor's per-group codec
            # embeddings are as wide as the talker (JAX's init makes them
            # as wide as the code predictor, and its generate() then fails)
            cp = jm.params["talker"]["code_predictor"]["model"]
            g1, vocab, _ = cp["codec_embedding"]["weight"].shape
            cp["codec_embedding"]["weight"] = 0.02 * jax.random.normal(
                jax.random.PRNGKey(2), (g1, vocab, jm.tcfg.hidden_size))
        if q:
            jm.params = maybe_quantize_tree(
                jm.params, group_size=16, bits=8,
                predicate=lambda p, w: jm.model_quant_predicate(p, w))
        _JAX[variant] = (jm, {k: np.asarray(v)
                              for k, v in flatten(jm.params).items()})
    return _JAX[variant]


def _port(variant):
    from mlx_audio_tpu_torch.tts.models.qwen3_tts import (Model, ModelConfig,
                                                          load_jax_params)

    jm, flat = _jax_model(variant)
    cfg = ModelConfig.from_dict(dataclasses.asdict(jm.config))
    return load_jax_params(Model(cfg, device="cpu"), flat)


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------


def test_rope_and_rms_norm_match_jax():
    from mlx_audio_tpu.nn import apply_rms_norm
    from mlx_audio_tpu.ops.rope import apply_rope as japply
    from mlx_audio_tpu.ops.rope import rope_freqs as jfreqs
    from mlx_audio_tpu_torch.nn import rms_norm
    from mlx_audio_tpu_torch.ops.rope import apply_rope, rope_freqs

    rng = np.random.RandomState(0)
    x = rng.randn(2, 7, 4, 16).astype(np.float32)
    pos = np.arange(3, 10)[None].repeat(2, 0)
    want = japply(jnp.asarray(x), jnp.asarray(pos), jfreqs(16, 1e6))
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                     rope_freqs(16, 1e6))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL,
                               rtol=1e-5)
    w = rng.randn(16).astype(np.float32)
    want = apply_rms_norm({"weight": jnp.asarray(w)}, jnp.asarray(x), 1e-6)
    got = rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL,
                               rtol=1e-5)


@pytest.mark.parametrize("hq,hkv,kind", [(4, 2, "mask"), (4, 2, "prefill"),
                                         (4, 4, "prefill"), (6, 2, "none")])
def test_attention_matches_jax(hq, hkv, kind):
    """A random additive mask, and the talker prefill's: causal over a
    cache longer than the prompt, plus the right-pad mask past row plen."""
    from mlx_audio_tpu.ops.attention import attention as jatt
    from mlx_audio_tpu_torch.ops.attention import attention

    rng = np.random.RandomState(1)
    q = rng.randn(2, 5, hq, 8).astype(np.float32)
    k = rng.randn(2, 9, hkv, 8).astype(np.float32)
    v = rng.randn(2, 9, hkv, 8).astype(np.float32)
    mask = None
    if kind == "mask":
        mask = np.where(rng.rand(2, 1, 5, 9) < 0.3, -np.inf, 0.0)
        mask[..., 0] = 0.0
    elif kind == "prefill":
        s, t = np.arange(9)[None, :], np.arange(5)[:, None]
        mask = np.where((s <= t) & (s < 4), 0.0, -np.inf)[None, None]
    if mask is not None:
        mask = mask.astype(np.float32)
    want = jatt(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                mask=None if mask is None else jnp.asarray(mask))
    got = attention(torch.from_numpy(q), torch.from_numpy(k),
                    torch.from_numpy(v),
                    mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL,
                               rtol=1e-5)


@pytest.mark.parametrize("length", [1, 7, 12])
def test_decode_attention_matches_jax(length):
    from mlx_audio_tpu.ops.attention import decode_attention as jdec
    from mlx_audio_tpu_torch.ops.attention import decode_attention

    rng = np.random.RandomState(2)
    q = rng.randn(2, 1, 4, 8).astype(np.float32)
    k = rng.randn(2, 12, 2, 8).astype(np.float32)
    v = rng.randn(2, 12, 2, 8).astype(np.float32)
    want = jdec(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), length)
    got = decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), length)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL,
                               rtol=1e-5)


def test_kv_update_writes_in_place_like_jax():
    from mlx_audio_tpu.ops.kvcache import KVCache as JKV
    from mlx_audio_tpu.ops.kvcache import kv_update as jupd
    from mlx_audio_tpu_torch.ops.kvcache import KVCache, kv_update

    rng = np.random.RandomState(3)
    kn, vn = (rng.randn(1, 3, 2, 4).astype(np.float32) for _ in range(2))
    want = jupd(JKV.init(1, 8, 2, 4, jnp.float32), jnp.asarray(kn),
                jnp.asarray(vn), jnp.int32(4))
    stacked = KVCache.init(1, 8, 2, 4, torch.float32, n_layers=2)
    layer = stacked.layer(1)
    kv_update(layer, torch.from_numpy(kn), torch.from_numpy(vn), 4)
    np.testing.assert_array_equal(_np(stacked.k[1]), np.asarray(want.k))
    np.testing.assert_array_equal(_np(stacked.v[1]), np.asarray(want.v))
    assert not stacked.k[0].any()


@pytest.mark.parametrize("case", ["penalty", "top_k", "top_p", "top_k_top_p"])
def test_sampling_filters_match_jax(case):
    from mlx_audio_tpu.ops import sampling as js
    from mlx_audio_tpu_torch.ops import sampling as ts

    rng = np.random.RandomState(4)
    lg = rng.randn(3, 50).astype(np.float32) * 3
    if case == "penalty":
        hist = np.array([[1, 2, -1], [-1, -1, -1], [49, 0, 0]], np.int32)
        want = js.apply_repetition_penalty(jnp.asarray(lg), jnp.asarray(hist),
                                           1.3)
        got = ts.apply_repetition_penalty(torch.from_numpy(lg),
                                          torch.from_numpy(hist), 1.3)
    else:
        kw = {"top_k": dict(top_k=5), "top_p": dict(top_p=0.7),
              "top_k_top_p": dict(top_k=10, top_p=0.5)}[case]
        want = js.top_k_top_p_filter(jnp.asarray(lg), **kw)
        got = ts.top_k_top_p_filter(torch.from_numpy(lg), **kw)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_sample_uses_its_generator():
    from mlx_audio_tpu_torch.ops.sampling import sample

    lg = torch.from_numpy(np.random.RandomState(5).randn(4, 30)
                          .astype(np.float32))

    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        return torch.stack([sample(lg, 0.9, top_k=3, generator=g)
                            for _ in range(20)])

    a, b = draw(7), draw(7)
    assert torch.equal(a, b) and a.dtype == torch.int64
    top3 = torch.topk(lg, 3).indices
    assert all(int(t) in top3[r].tolist() for r in range(4) for t in a[:, r])
    assert torch.equal(sample(lg, 0.0), lg.argmax(-1))


# ---------------------------------------------------------------------------
# talker, code predictor, codec
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["tiny", "wide", "tiny-q8"])
def test_talker_prefill_matches_jax(variant):
    """Prefill over a right-padded bucket (the generate path's `_prefill`)
    and the whole padded logits/cache of the talker forward."""
    from mlx_audio_tpu.tts.models.qwen3_tts.talker import (
        make_stacked_caches, talker_forward)

    jm, _ = _jax_model(variant)
    pm = _port(variant)
    tcfg = jm.tcfg
    pb, plen, cache_len = 16, 11, 40
    emb = (np.random.RandomState(6).randn(1, pb, tcfg.hidden_size) * 0.3
           ).astype(np.float32)
    l0, h0, _ = jm._make_prefill(pb, cache_len)(jm.params, jnp.asarray(emb),
                                                jnp.int32(plen))
    with torch.no_grad():
        pl0, ph0, pcache = pm._prefill(torch.from_numpy(emb), plen, cache_len)
    np.testing.assert_allclose(_np(pl0), np.asarray(l0), atol=ATOL, rtol=1e-5)
    np.testing.assert_allclose(_np(ph0), np.asarray(h0), atol=ATOL, rtol=1e-5)

    caches = make_stacked_caches(tcfg.num_hidden_layers, 1, cache_len,
                                 tcfg.num_key_value_heads, tcfg.head_dim,
                                 jnp.float32)
    pad = np.where(np.arange(cache_len) < plen, 0.0, -np.inf)
    pad = pad.astype(np.float32)[None, None, None]
    logits, hidden, caches = talker_forward(
        jm.params["talker"], tcfg, jnp.asarray(emb), caches, 0,
        lengths_mask=jnp.asarray(pad))
    np.testing.assert_allclose(_np(pcache.k), np.asarray(caches.k),
                               atol=ATOL, rtol=1e-5)
    with torch.no_grad():
        cache = pm.talker.make_cache(1, cache_len, torch.float32, "cpu")
        plogits, phidden = pm.talker(torch.from_numpy(emb), cache, 0,
                                     lengths_mask=torch.from_numpy(pad))
    np.testing.assert_allclose(_np(plogits), np.asarray(logits), atol=ATOL,
                               rtol=1e-5)
    np.testing.assert_allclose(_np(phidden), np.asarray(hidden), atol=ATOL,
                               rtol=1e-5)


def test_talker_cached_decode_matches_full():
    """As tests/test_qwen3_tts.py::test_cached_decode_matches_full, on the
    port: a 4-token prefill, then one-token steps, equal the uncached
    pass."""
    pm = _port("tiny")
    emb = torch.from_numpy((np.random.RandomState(7).randn(1, 7, 32) * 0.1)
                           .astype(np.float32))
    with torch.no_grad():
        full, _ = pm.talker(emb, None, 0)
        cache = pm.talker.make_cache(1, 16, torch.float32, "cpu")
        part, _ = pm.talker(emb[:, :4], cache, 0)
        np.testing.assert_allclose(_np(part), _np(full[:, :4]), atol=1e-4)
        for i in range(4, 7):
            step, _ = pm.talker(emb[:, i:i + 1], cache, i)
            np.testing.assert_allclose(_np(step[:, 0]), _np(full[:, i]),
                                       atol=1e-4)


@pytest.mark.parametrize("variant", ["tiny", "wide", "wide-q8"])
def test_code_predictor_matches_jax(variant):
    """Sub-step 0 (T=2 into a fresh G+2 cache) and sub-step 1 (T=1)
    logits, then the greedy codes and summed embedding of one frame."""
    from mlx_audio_tpu.tts.models.qwen3_tts.talker import (
        code_predictor_forward, code_predictor_sample, make_stacked_caches)
    from mlx_audio_tpu_torch.ops.kvcache import KVCache

    jm, _ = _jax_model(variant)
    pm = _port(variant)
    cpcfg, g = jm.cpcfg, jm.tcfg.num_code_groups
    cp = jm.params["talker"]["code_predictor"]
    rng = np.random.RandomState(8)
    x0 = (rng.randn(1, 2, jm.tcfg.hidden_size) * 0.5).astype(np.float32)
    x1 = (rng.randn(1, 1, jm.tcfg.hidden_size) * 0.5).astype(np.float32)
    caches = make_stacked_caches(cpcfg.num_hidden_layers, 1, g + 2,
                                 cpcfg.num_key_value_heads, cpcfg.head_dim,
                                 jnp.float32)
    want0, caches = code_predictor_forward(cp, cpcfg, jnp.asarray(x0), caches,
                                           jnp.int32(0), 0)
    want1, _ = code_predictor_forward(cp, cpcfg, jnp.asarray(x1), caches,
                                      jnp.int32(2), 1)
    with torch.no_grad():
        pc = pm.talker.code_predictor
        cache = KVCache.init(1, g + 2, cpcfg.num_key_value_heads,
                                 cpcfg.head_dim, torch.float32,
                                 n_layers=cpcfg.num_hidden_layers)
        got0 = pc(torch.from_numpy(x0), cache, 0, 0)
        got1 = pc(torch.from_numpy(x1), cache, 2, 1)
    np.testing.assert_allclose(_np(got0), np.asarray(want0), atol=ATOL,
                               rtol=1e-5)
    np.testing.assert_allclose(_np(got1), np.asarray(want1), atol=ATOL,
                               rtol=1e-5)

    hidden = x0[:, :1]
    code0 = np.asarray(jm.params["talker"]["model"]["codec_embedding"][
        "weight"])[[[17]]]
    codes, emb_sum, _ = code_predictor_sample(
        cp, cpcfg, jnp.asarray(hidden), jnp.asarray(code0),
        jax.random.PRNGKey(0),
        lambda k, lg: jnp.argmax(lg, -1).astype(jnp.int32), g)
    with torch.no_grad():
        pcodes, pemb = pm.talker.code_predictor.sample(
            torch.from_numpy(hidden), torch.from_numpy(code0),
            lambda lg: lg.argmax(-1))
    np.testing.assert_array_equal(pcodes.numpy(), np.asarray(codes))
    np.testing.assert_allclose(_np(pemb), np.asarray(emb_sum), atol=ATOL,
                               rtol=1e-5)


def test_decode_full_matches_jax():
    from mlx_audio_tpu.tts.models.qwen3_tts.speech_tokenizer import (
        decode_full)

    jm, _ = _jax_model("tiny")
    pm = _port("tiny")
    codes = np.random.RandomState(9).randint(0, 256, (2, 4, 23))
    want = decode_full(jm.params["speech_tokenizer"]["decoder"], jm.dcfg,
                       jnp.asarray(codes))
    with torch.no_grad():
        got = pm.speech_tokenizer.decoder(torch.from_numpy(codes))
    assert got.shape == (2, 23 * pm.total_upsample)
    assert _rel(_np(got), np.asarray(want)) <= AUDIO_REL


# ---------------------------------------------------------------------------
# generate
# ---------------------------------------------------------------------------


def _port_codes(pm, **kw):
    """Run the port's generate(); return (result, codes fed to the codec)."""
    seen = []
    hook = pm.speech_tokenizer.decoder.register_forward_pre_hook(
        lambda mod, args: seen.append(args[0].clone()))
    try:
        (r,) = list(pm.generate(**kw))
    finally:
        hook.remove()
    return r, seen[0].numpy()


@pytest.mark.parametrize("variant", ["tiny", "tiny-q8", "wide", "wide-q8"])
def test_generate_greedy_codes_match_jax(variant):
    from mlx_audio_tpu.tts.models.qwen3_tts.speech_tokenizer import (
        decode_full)

    jm, _ = _jax_model(variant)
    pm = _port(variant)
    kw = dict(text_ids=np.arange(10, 36)[None], temperature=0.0,
              max_tokens=21)
    (want,) = list(jm.generate(**kw))
    got, codes = _port_codes(pm, **kw)
    assert got.token_count == want.token_count == codes.shape[-1]
    assert got.samples == codes.shape[-1] * pm.total_upsample
    # the port's codes through JAX's own decoder give JAX's audio
    audio = decode_full(jm.params["speech_tokenizer"]["decoder"], jm.dcfg,
                        jnp.asarray(codes))[0]
    assert _rel(np.asarray(audio), np.asarray(want.audio)) <= 1e-6
    assert _rel(got.audio, np.asarray(want.audio)) <= AUDIO_REL
    assert np.isfinite(got.audio).all()


def _decode_steps(frames, max_tokens):
    """Steps the chunk loop runs for `frames` kept frames: FIRST_CHUNK, then
    CHUNK_TOKENS, cut to the token budget; EOS at decode step s (then
    frames == s) stops it STEPS_AFTER_EOS steps later, or at the end of the
    chunk if that comes first."""
    from mlx_audio_tpu_torch.tts.models.qwen3_tts.qwen3_tts import (
        CHUNK_TOKENS, FIRST_CHUNK, STEPS_AFTER_EOS)

    ends = np.cumsum([FIRST_CHUNK] + [CHUNK_TOKENS] * max_tokens)
    ends = np.minimum(ends, max_tokens - 1)
    if frames >= max_tokens:
        return max_tokens - 1
    return int(min(frames + STEPS_AFTER_EOS, ends[ends >= frames][0]))


def test_generate_chunk_schedule_and_counts():
    """The chunk loop runs FIRST_CHUNK then CHUNK_TOKENS steps, reading the
    codes once per chunk and stopping at most STEPS_AFTER_EOS steps after
    EOS; text_projection runs once for the text and, the first time, once
    for the cached tts ids; sampling is seeded."""
    pm = _port("tiny-q8")
    kw = dict(text_ids=np.arange(10, 30)[None], temperature=0.9,
              max_tokens=40, seed=3)
    r1, c1 = _port_codes(pm, **kw)
    run1 = dict(pm.last_run)
    r2, c2 = _port_codes(pm, **kw)
    np.testing.assert_array_equal(c1, c2)
    assert run1["text_projection_calls"] == 2
    assert pm.last_run["text_projection_calls"] == 1
    assert run1["prompt_bucket"] == 16 and run1["step0"] == 1
    if r1.token_count == kw["max_tokens"]:       # no EOS: every step kept
        assert run1["decode_steps"] == kw["max_tokens"] - 1
    assert run1["decode_steps"] == _decode_steps(r1.token_count,
                                                 kw["max_tokens"])


@pytest.mark.parametrize("eos_step", [15, 32, 33])
def test_generate_stops_after_eos(monkeypatch, eos_step):
    """EOS forced at a known decode step (inside the second, 25-step chunk;
    at its last step but one; at its last step): the loop runs at most
    STEPS_AFTER_EOS more steps, and keeps the codes of the same request
    with EOS suppressed, cut at EOS."""
    from mlx_audio_tpu_torch.tts.models.qwen3_tts import qwen3_tts as qmod
    from mlx_audio_tpu_torch.tts.models.qwen3_tts.qwen3_tts import (
        STEPS_AFTER_EOS)

    pm = _port("tiny-q8")
    eos, vocab = pm.tcfg.codec_eos_token_id, pm.tcfg.vocab_size
    assert pm.cpcfg.vocab_size != vocab
    plain_sample = qmod.sample

    def run(force_at):
        talker_calls = []

        def sample(logits, *args, **kw):
            if logits.shape[-1] != vocab:            # a code-predictor group
                return plain_sample(logits, *args, **kw)
            logits = logits.clone()
            logits[:, eos] = float("-inf")
            tok = plain_sample(logits, *args, **kw)  # same random draws
            if len(talker_calls) == force_at:        # call 0 is step 0
                tok = torch.full_like(tok, eos)
            talker_calls.append(int(tok[0]))
            return tok

        monkeypatch.setattr(qmod, "sample", sample)
        r, codes = _port_codes(pm, text_ids=np.arange(10, 30)[None],
                               temperature=0.9, max_tokens=50, seed=5)
        return r, codes, pm.last_run["decode_steps"], talker_calls

    r, codes, steps, calls = run(eos_step)
    r_free, codes_free, steps_free, _ = run(None)
    assert calls[eos_step] == eos and eos not in calls[:eos_step]
    assert r.token_count == codes.shape[-1] == eos_step
    assert steps <= eos_step + STEPS_AFTER_EOS
    assert steps == _decode_steps(eos_step, 50) == len(calls) - 1
    assert steps_free == 49 and r_free.token_count == 50
    np.testing.assert_array_equal(codes, codes_free[..., :eos_step])
    assert r.samples == eos_step * pm.total_upsample


def test_first_frame_eos_ends_the_request_with_no_audio(monkeypatch):
    """EOS sampled at step 0 (from the prefill logits): the whole request
    ends with a zero-length final result and decodes nothing (EOS lies past
    the codec's codebooks: an index error on the CPU, a device-side assert
    on the card), as the stream and the session do; last_run is filled."""
    from mlx_audio_tpu_torch.tts.models.qwen3_tts import qwen3_tts as qmod

    pm = _port("tiny-q8")
    eos, vocab = pm.tcfg.codec_eos_token_id, pm.tcfg.vocab_size
    plain_sample = qmod.sample

    def sample(logits, *args, **kw):
        tok = plain_sample(logits, *args, **kw)
        return torch.full_like(tok, eos) if logits.shape[-1] == vocab else tok

    monkeypatch.setattr(qmod, "sample", sample)
    decoded = []
    hook = pm.speech_tokenizer.decoder.register_forward_pre_hook(
        lambda mod, args: decoded.append(1))
    try:
        (r,) = list(pm.generate(text_ids=np.arange(10, 30)[None],
                                temperature=0.9, max_tokens=20, seed=0))
    finally:
        hook.remove()
    assert decoded == []
    assert r.is_final_chunk and r.samples == 0 and r.token_count == 0
    assert r.audio.shape == (0,)
    assert pm.last_run["step0"] == 1 and pm.last_run["decode_steps"] == 0
    assert pm.last_run["prompt_bucket"] == 16


def test_max_tokens_past_the_kv_cap_raises_before_the_prefill(monkeypatch):
    """The prompt bucket plus max_tokens must fit MAX_CACHE_LEN: past it,
    generate() raises ValueError before any prefill (the JAX package clamps
    the KV writes and corrupts the late audio; the port's in-place write
    would fail mid-request). A request that just fits runs, whole and
    streamed. The cap is cut to 64 here so that the fit runs quickly."""
    from mlx_audio_tpu_torch.tts.models.qwen3_tts import qwen3_tts as qmod

    pm = _port("tiny-q8")
    monkeypatch.setattr(qmod, "MAX_CACHE_LEN", 64)
    calls = []
    real = pm._prefill
    monkeypatch.setattr(pm, "_prefill",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    kw = dict(text_ids=np.arange(10, 30)[None], temperature=0.9, seed=0)
    for stream in (False, True):
        with pytest.raises(ValueError, match="KV cache"):
            list(pm.generate(max_tokens=64 - 16 + 1, stream=stream, **kw))
    assert calls == []
    (r,) = list(pm.generate(max_tokens=64 - 16, **kw))
    assert calls == [1] and 0 < r.token_count <= 48
    chunks = list(pm.generate(max_tokens=64 - 16, stream=True,
                              streaming_interval=0.4, **kw))
    assert chunks[-1].is_final_chunk and calls == [1, 1]


def test_load_model_reads_a_torch_layout_checkpoint(tmp_path):
    """A checkpoint directory in the published layout (per-group code-
    predictor tables, codebooks as embedding_sum / cluster_usage, the codec
    in speech_tokenizer/) loads through `load_model`, quantized per its
    config, and generates what the model it was written from does."""
    import json

    from mlx_audio_tpu_torch import load_model
    from mlx_audio_tpu_torch.utils import apply_quantization

    pm = _port("wide")
    main, codec = {}, {}
    for k, v in pm.state_dict().items():
        v = v.numpy()
        if k.endswith(("code_predictor.lm_head.weight",
                       "code_predictor.model.codec_embedding.weight")):
            for i, table in enumerate(v):
                main[f"{k[:-len('.weight')]}.{i}.weight"] = table
        elif k.endswith("codebook.embed.weight"):
            base = k[:-len(".codebook.embed.weight")]
            usage = np.full(v.shape[0], 2.0, np.float32)
            codec[f"{base}._codebook.embedding_sum"[len(
                "speech_tokenizer."):]] = v * 2.0
            codec[f"{base}._codebook.cluster_usage"[len(
                "speech_tokenizer."):]] = usage
        elif k.startswith("speech_tokenizer."):
            codec[k[len("speech_tokenizer."):]] = v
        else:
            main[k] = v
    cfg = dataclasses.asdict(pm.config)
    cfg["quantization"] = {"bits": 8, "group_size": 16}
    (tmp_path / "speech_tokenizer").mkdir()
    np.savez(tmp_path / "model.npz", **main)
    np.savez(tmp_path / "speech_tokenizer" / "model.npz", **codec)
    (tmp_path / "config.json").write_text(json.dumps(cfg))

    loaded = load_model(tmp_path, device="cpu")
    ref = apply_quantization(pm, cfg, pm.model_quant_predicate)
    n_q = sum(type(m).__name__ == "QuantizedLinear" for m in loaded.modules())
    # talker and code-predictor projections and codec_head; text_projection
    # (in 40) stays dense: 40 is not a multiple of the group size 16
    assert n_q == 2 * 7 + 1 + 2 * 7
    kw = dict(text_ids=np.arange(10, 30)[None], temperature=0.0,
              max_tokens=12)
    _, want = _port_codes(ref, **kw)
    _, got = _port_codes(loaded, **kw)
    np.testing.assert_array_equal(got, want)


def test_quantized_tree_loads_as_uint8_codes():
    jm, flat = _jax_model("tiny-q8")
    pm = _port("tiny-q8")
    q = pm.talker.model.layers[1].mlp.down_proj
    assert type(q).__name__ == "QuantizedLinear"
    assert q.w_q.dtype == torch.uint8 and q.scales.dtype == torch.float32
    np.testing.assert_array_equal(
        q.w_q.numpy(), flat["talker.model.layers.mlp.down_proj.w_q"][1])
    assert type(pm.talker.code_predictor.small_to_mtp_projection) is type(None)
    assert type(pm.speech_tokenizer.decoder.pre_transformer.input_proj
                ).__name__ == "Linear"


def test_init_params_sets_the_decoder_constants():
    from mlx_audio_tpu_torch.tts.models.qwen3_tts import Model, ModelConfig

    pm = Model(ModelConfig.from_dict(dataclasses.asdict(_jax_cfg("tiny"))),
               device="cpu")
    pm.init_params(seed=0)
    d = pm.speech_tokenizer.decoder
    assert torch.all(d.decoder[1].block[0].alpha == 0)
    assert torch.all(d.upsample[0][1].gamma == torch.tensor(1e-6))
    assert torch.all(
        d.pre_transformer.layers[0].mlp_layer_scale.scale == torch.tensor(0.01))
    assert torch.all(pm.talker.model.layers[0].self_attn.q_norm.weight == 1)
    (r,) = list(pm.generate(text_ids=np.arange(10, 30)[None],
                            temperature=0.9, max_tokens=9))
    assert r.samples == r.token_count * pm.total_upsample
    assert np.isfinite(r.audio).all()


@pytest.mark.parametrize("kw", [dict(ref_audio=np.zeros(8)),
                                dict(instruct="calm"),
                                dict(text_ids=np.ones((2, 20), int))])
def test_unported_paths_raise(kw):
    pm = _port("tiny")
    kw = {"text_ids": np.arange(10, 30)[None], **kw}
    with pytest.raises(NotImplementedError):
        list(pm.generate(**kw))
