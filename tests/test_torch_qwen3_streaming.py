"""Qwen3-TTS streaming in the PyTorch port against the JAX package, on the
CPU at float32: the per-row KV writes, the (B, S) validity mask of decode
attention, the talker's RoPE `positions` override, the streaming codec
(`streaming_step`, its row-masked batched form) and `generate(stream=True)`.

Models: the `tiny` and `tiny-q8` variants of tests/test_torch_qwen3_tts.py
(the JAX tiny config with its tts ids moved inside the text vocabulary),
built from one parameter tree through `model.load_jax_params`.

Tolerances: ops and layer outputs 2e-4 absolute (summation order only, the
repo's torch-parity precedent); codec audio 1e-4 relative to its largest
value (~1e-3 under random weights); streamed against one-shot audio in the
port 2e-4 absolute, as tests/test_qwen3_tts.py holds the JAX package.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_qwen3_tts import (ATOL, AUDIO_REL, _jax_model, _np,  # noqa: E402
                                  _port, _rel)

CHUNKS = [(0, 5), (5, 6), (6, 14), (14, 24)]


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------


def test_kv_update_rows_matches_jax():
    from mlx_audio_tpu.ops.kvcache import KVCache as JKV
    from mlx_audio_tpu.ops.kvcache import kv_update_rows as jupd
    from mlx_audio_tpu_torch.ops.kvcache import KVCache, kv_update_rows

    rng = np.random.RandomState(0)
    k0, v0 = (rng.randn(3, 12, 2, 4).astype(np.float32) for _ in range(2))
    kn, vn = (rng.randn(3, 4, 2, 4).astype(np.float32) for _ in range(2))
    off = np.array([0, 5, 8], np.int32)
    want = jupd(JKV(jnp.asarray(k0), jnp.asarray(v0)), jnp.asarray(kn),
                jnp.asarray(vn), jnp.asarray(off))
    cache = KVCache(torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy()))
    got = kv_update_rows(cache, torch.from_numpy(kn), torch.from_numpy(vn),
                         torch.from_numpy(off))
    assert got.k is cache.k                       # written in place
    np.testing.assert_allclose(_np(cache.k), np.asarray(want.k), atol=ATOL)
    np.testing.assert_allclose(_np(cache.v), np.asarray(want.v), atol=ATOL)


@pytest.mark.parametrize("stacked", [False, True])
def test_kv_update_row_matches_jax(stacked):
    """One row's prefill spliced at (row, offset), on a layer's cache and on
    the stacked (L, B, T, H, D) cache of the session."""
    from mlx_audio_tpu.ops.kvcache import KVCache as JKV
    from mlx_audio_tpu.ops.kvcache import kv_update_row as jupd
    from mlx_audio_tpu_torch.ops.kvcache import KVCache, kv_update_row

    rng = np.random.RandomState(1)
    n_layers = 2 if stacked else 1
    k0, v0 = (rng.randn(n_layers, 3, 10, 2, 4).astype(np.float32)
              for _ in range(2))
    kn, vn = (rng.randn(n_layers, 4, 2, 4).astype(np.float32)
              for _ in range(2))
    want = [jupd(JKV(jnp.asarray(k0[i]), jnp.asarray(v0[i])), 2,
                 jnp.asarray(kn[i]), jnp.asarray(vn[i]), 3)
            for i in range(n_layers)]
    cache = KVCache(torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy()))
    if not stacked:
        cache = cache.layer(0)
        kn, vn = kn[0], vn[0]
    kv_update_row(cache, 2, torch.from_numpy(kn), torch.from_numpy(vn), 3)
    got_k = _np(cache.k).reshape(k0.shape)
    got_v = _np(cache.v).reshape(v0.shape)
    np.testing.assert_allclose(got_k, np.stack([np.asarray(w.k) for w in want]),
                               atol=ATOL)
    np.testing.assert_allclose(got_v, np.stack([np.asarray(w.v) for w in want]),
                               atol=ATOL)


@pytest.mark.parametrize("form", ["lengths_mask", "per_row_length"])
def test_decode_attention_row_masks_match_jax(form):
    from mlx_audio_tpu.ops.attention import decode_attention as jdec
    from mlx_audio_tpu_torch.ops.attention import decode_attention

    rng = np.random.RandomState(2)
    q = rng.randn(3, 1, 4, 8).astype(np.float32)
    k = rng.randn(3, 12, 2, 8).astype(np.float32)
    v = rng.randn(3, 12, 2, 8).astype(np.float32)
    if form == "lengths_mask":
        mask = rng.rand(3, 12) < 0.5
        mask[:, 3] = True
        want = jdec(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 12,
                    lengths_mask=jnp.asarray(mask))
        got = decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), 12,
                               lengths_mask=torch.from_numpy(mask))
    else:
        length = np.array([1, 7, 12], np.int32)
        want = jdec(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    jnp.asarray(length))
        got = decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), torch.from_numpy(length))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL,
                               rtol=1e-5)


@pytest.mark.parametrize("variant", ["tiny", "tiny-q8"])
def test_talker_positions_override_matches_jax(variant):
    """The session's decode step: every row writes at the shared column t,
    rotates at its own row_len and attends to its valid columns plus t."""
    from mlx_audio_tpu.ops.kvcache import KVCache as JKV
    from mlx_audio_tpu.tts.models.qwen3_tts.talker import talker_forward
    from mlx_audio_tpu_torch.ops.kvcache import KVCache

    jm, _ = _jax_model(variant)
    pm = _port(variant)
    tcfg = jm.tcfg
    rng = np.random.RandomState(3)
    b, s, t = 3, 24, 13
    shape = (tcfg.num_hidden_layers, b, s, tcfg.num_key_value_heads,
             tcfg.head_dim)
    k0, v0 = (rng.randn(*shape).astype(np.float32) * 0.5 for _ in range(2))
    emb = (rng.randn(b, 1, tcfg.hidden_size) * 0.3).astype(np.float32)
    valid = rng.rand(b, s) < 0.5
    valid[:, t] = True
    valid[:, t + 1:] = False
    row_len = np.array([[4], [9], [13]], np.int32)
    logits, hidden, caches = talker_forward(
        jm.params["talker"], tcfg, jnp.asarray(emb),
        JKV(jnp.asarray(k0), jnp.asarray(v0)), t,
        lengths_mask=jnp.asarray(valid), positions=jnp.asarray(row_len))
    cache = KVCache(torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy()))
    with torch.no_grad():
        plogits, phidden = pm.talker(
            torch.from_numpy(emb), cache, t,
            lengths_mask=torch.from_numpy(valid),
            positions=torch.from_numpy(row_len).long())
    np.testing.assert_allclose(_np(plogits), np.asarray(logits), atol=ATOL,
                               rtol=1e-5)
    np.testing.assert_allclose(_np(phidden), np.asarray(hidden), atol=ATOL,
                               rtol=1e-5)
    np.testing.assert_allclose(_np(cache.k), np.asarray(caches.k), atol=ATOL,
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# the streaming codec
# ---------------------------------------------------------------------------


def _codes(seed, b, t):
    return np.random.RandomState(seed).randint(0, 256, (b, 4, t))


def test_streaming_step_matches_jax():
    """streaming_step over uneven chunks, each chunk's audio against the
    JAX package's at 1e-4 relative."""
    from mlx_audio_tpu.tts.models.qwen3_tts.speech_tokenizer import (
        init_stream_state as jinit, streaming_step as jstep)
    from mlx_audio_tpu_torch.tts.models.qwen3_tts.speech_tokenizer import (
        init_stream_state)

    jm, _ = _jax_model("tiny")
    pm = _port("tiny")
    codes = _codes(1, 1, 24)
    jstate = jinit(jm.dcfg, batch=1)
    state = init_stream_state(pm.dcfg, batch=1)
    dec = pm.speech_tokenizer.decoder
    for start, end in CHUNKS:
        jstate, want = jstep(jm.params["speech_tokenizer"]["decoder"],
                             jm.dcfg, jstate,
                             jnp.asarray(codes[:, :, start:end]))
        with torch.no_grad():
            state, got = dec.streaming_step(
                state, torch.from_numpy(codes[:, :, start:end]))
        assert got.shape == (1, (end - start) * pm.total_upsample)
        assert _rel(_np(got), np.asarray(want)) <= AUDIO_REL
    assert int(state["offset"]) == 24


def test_streaming_matches_decode_full():
    """As tests/test_qwen3_tts.py::test_streaming_matches_full, on the
    port: chunked streaming equals the one-shot decode."""
    from mlx_audio_tpu_torch.tts.models.qwen3_tts.speech_tokenizer import (
        init_stream_state)

    pm = _port("tiny")
    dec = pm.speech_tokenizer.decoder
    codes = torch.from_numpy(_codes(1, 2, 24))
    with torch.no_grad():
        full = dec(codes)
        state = init_stream_state(pm.dcfg, batch=2)
        outs = []
        for start, end in CHUNKS:
            state, chunk = dec.streaming_step(state, codes[:, :, start:end])
            outs.append(chunk)
    streamed = torch.cat(outs, dim=-1)
    assert streamed.shape == full.shape
    np.testing.assert_allclose(_np(streamed), _np(full), atol=2e-4)


def draw_codec_biases(model, seed=0, scale=0.1):
    """Every bias of the port's codec decoder drawn N(0, scale) from a numpy
    seed, in place (a trained checkpoint's are not zero; the tiny
    config's init leaves them so). -> {name: array} under the names both
    packages share."""
    rng = np.random.RandomState(seed)
    drawn = {}
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.startswith("speech_tokenizer.decoder.") and \
                    name.endswith(".bias"):
                drawn[name] = (rng.randn(*p.shape) * scale).astype(np.float32)
                p.copy_(torch.from_numpy(drawn[name]))
    return drawn


def test_streaming_with_biases_matches_decode_full():
    """With every codec bias drawn N(0, 0.1), streaming_step over uneven
    chunks equals the one-shot decode within 2e-4: each overlap sample of
    a transposed conv (upsample stages and decoder blocks) holds the bias
    once. The JAX package's stream adds it twice there and strays (the
    departure in ROADMAP.md section 3)."""
    from mlx_audio_tpu.tts.models.qwen3_tts.speech_tokenizer import (
        decode_full as jfull, init_stream_state as jinit,
        streaming_step as jstep)
    from mlx_audio_tpu.utils import unflatten
    from mlx_audio_tpu_torch.tts.models.qwen3_tts.speech_tokenizer import (
        init_stream_state)

    pm = _port("tiny")
    drawn = draw_codec_biases(pm)
    assert any(".upsample." in k for k in drawn) and \
        any(".block.1.conv.bias" in k for k in drawn)
    dec = pm.speech_tokenizer.decoder
    codes = _codes(2, 2, 24)
    with torch.no_grad():
        full = dec(torch.from_numpy(codes))
        state = init_stream_state(pm.dcfg, batch=2)
        outs = []
        for start, end in CHUNKS:
            state, chunk = dec.streaming_step(
                state, torch.from_numpy(codes[:, :, start:end]))
            outs.append(chunk)
    np.testing.assert_allclose(_np(torch.cat(outs, -1)), _np(full),
                               atol=2e-4)

    jm, flat = _jax_model("tiny")
    prefix = "speech_tokenizer.decoder."
    jdec = unflatten({k[len(prefix):]: jnp.asarray(drawn.get(k, v))
                      for k, v in flat.items() if k.startswith(prefix)})
    jwant = np.asarray(jfull(jdec, jm.dcfg, jnp.asarray(codes)))
    np.testing.assert_allclose(jwant, _np(full), atol=2e-4)
    jstate, jouts = jinit(jm.dcfg, batch=2), []
    for start, end in CHUNKS:
        jstate, chunk = jstep(jdec, jm.dcfg, jstate,
                              jnp.asarray(codes[:, :, start:end]))
        jouts.append(np.asarray(chunk))
    assert np.abs(np.concatenate(jouts, -1) - jwant).max() > 1e-2


def _flat_state(state):
    """[(name, array)] of a streaming state, the port's or the JAX one."""
    out = []

    def walk(prefix, v):
        if isinstance(v, dict):
            for k in sorted(v):
                walk(f"{prefix}.{k}", v[k])
        elif isinstance(v, (list, tuple)) and not hasattr(v, "shape"):
            for i, x in enumerate(v):
                walk(f"{prefix}.{i}", x)
        else:
            out.append((prefix, np.asarray(v.numpy() if hasattr(v, "numpy")
                                           and isinstance(v, torch.Tensor)
                                           else v)))

    walk("", state)
    return out


def test_masked_batch_decode_matches_jax():
    """The session's row-masked batched decode with per-row offsets against
    JAX `_get_batch_stream_decoder`: masked rows' audio at 1e-4 relative,
    the whole state at 2e-4 after every step, and the rows outside the
    mask bit-for-bit unchanged."""
    from mlx_audio_tpu.tts.models.qwen3_tts.speech_tokenizer import (
        init_stream_state as jinit)
    from mlx_audio_tpu_torch.tts.models.qwen3_tts.speech_tokenizer import (
        init_stream_state)

    jm, _ = _jax_model("tiny")
    pm = _port("tiny")
    b, k = 3, 5
    fn = jm._get_batch_stream_decoder(b, k)
    jstate = jinit(jm.dcfg, batch=b, per_row_offset=True, cache_len=128)
    state = init_stream_state(pm.dcfg, batch=b, per_row_offset=True,
                              cache_len=128)
    dec = pm.speech_tokenizer.decoder
    masks = [[1, 0, 1], [1, 1, 0], [0, 1, 1], [1, 0, 0], [1, 1, 1]]
    for i, m in enumerate(masks):
        mask = np.array(m, bool)
        codes = _codes(10 + i, b, k)
        codes[~mask] = 0                          # padding, as the session
        jstate, want = fn(jm.params, jstate, jnp.asarray(codes),
                          jnp.asarray(mask))
        before = [(n, a.copy()) for n, a in _flat_state(state)]
        with torch.no_grad():
            state, got = dec.streaming_step(state, torch.from_numpy(codes),
                                            torch.from_numpy(mask))
        assert _rel(_np(got)[mask], np.asarray(want)[mask]) <= AUDIO_REL
        for (name, old), (_, new) in zip(before, _flat_state(state)):
            np.testing.assert_array_equal(new[~mask], old[~mask], name)
        for (name, a), (_, w) in zip(_flat_state(state),
                                     _flat_state(jstate)):
            np.testing.assert_allclose(a, np.asarray(w), atol=ATOL,
                                       err_msg=name)
    assert _np(state["offset"]).tolist() == [4 * k, 3 * k, 3 * k]


# ---------------------------------------------------------------------------
# generate(stream=True)
# ---------------------------------------------------------------------------


def _stream(model, **kw):
    return list(model.generate(stream=True, **kw))


@pytest.mark.parametrize("variant,interval,max_tokens",
                         [("tiny", 0.5, 40), ("tiny", 2.0, 60),
                          ("tiny-q8", 0.4, 30)])
def test_stream_greedy_matches_jax(variant, interval, max_tokens):
    """Greedy: the same chunks (frames and tokens per result that
    carries audio) as the JAX package's stream, and the same audio at 1e-4
    relative."""
    jm, _ = _jax_model(variant)
    pm = _port(variant)
    kw = dict(text_ids=np.arange(10, 36)[None], temperature=0.0,
              max_tokens=max_tokens, streaming_interval=interval)
    want = _stream(jm, **kw)
    got = _stream(pm, **kw)
    # the chunks that carry audio; a stream may end with an empty final
    # result, and the port, which learns of EOS sooner, may need none
    assert [(r.samples, r.token_count) for r in got if r.samples] == \
        [(r.samples, r.token_count) for r in want if r.samples]
    assert got[-1].is_final_chunk and want[-1].is_final_chunk
    a = np.concatenate([r.audio for r in got])
    w = np.concatenate([np.asarray(r.audio) for r in want])
    assert len(a) and _rel(a, w) <= AUDIO_REL
    assert all(r.is_streaming_chunk for r in got)


@pytest.mark.parametrize("variant", ["tiny", "tiny-q8"])
def test_stream_audio_matches_nonstream(variant):
    """Greedy: the streamed chunks concatenated equal the one-shot decode
    of the same codes (tests/test_qwen3_tts.py::
    test_stream_audio_matches_nonstream)."""
    pm = _port(variant)
    kw = dict(text_ids=np.arange(10, 25)[None], temperature=0.0,
              max_tokens=20)
    stream = _stream(pm, streaming_interval=0.5, **kw)
    (full,) = list(pm.generate(**kw))
    a = np.concatenate([r.audio for r in stream])
    assert a.shape == full.audio.shape
    np.testing.assert_allclose(a, full.audio, atol=2e-4)


def test_stream_max_tokens_one():
    """Budget fully consumed by step 0: the flush-only superstep still
    emits the single frame and a final marker."""
    pm = _port("tiny")
    results = _stream(pm, text_ids=np.arange(10, 25)[None], temperature=0.0,
                      max_tokens=1)
    assert results[-1].is_final_chunk
    assert sum(r.samples for r in results) == pm.total_upsample
    assert pm.last_run["decode_steps"] == 0


def test_stream_stats_recorded():
    """One read per dispatched chunk, and the host's wait in them."""
    pm = _port("tiny")
    _stream(pm, text_ids=np.arange(10, 25)[None], temperature=0.0,
            max_tokens=20, streaming_interval=1.0)
    stats = pm._last_stream_stats
    # chunks: the first (8 frames) and the 11 frames left
    assert stats["n_fetches"] == 2
    assert stats["stall_s"] >= 0.0


@pytest.mark.parametrize("max_tokens", [5, 9, 17])
def test_stream_token_budget_respected(max_tokens):
    """Frames streamed never exceed max_tokens, and the last result is
    final."""
    pm = _port("tiny")
    results = _stream(pm, text_ids=np.arange(10, 25)[None], temperature=0.9,
                      max_tokens=max_tokens, streaming_interval=0.4, seed=3)
    total = sum(r.samples for r in results)
    assert 0 < total <= max_tokens * pm.total_upsample
    assert total % pm.total_upsample == 0
    assert results[-1].is_final_chunk


def test_late_eos_partial_block_not_truncated(monkeypatch):
    """EOS may flush a partial codec block on any chunk (flush = all
    finished | final): here EOS is the 25th step of the second chunk, so
    that chunk flushes 25 frames, of which a floor bound would fetch 24.
    The AR steps are replaced by a stand-in that emits K valid frames in
    all, then EOS (as tests/test_qwen3_tts.py replaces the JAX AR chunk)."""
    from mlx_audio_tpu_torch.tts.models.qwen3_tts import qwen3_tts as q

    pm = _port("tiny")
    K = 33                # step 0's frame + 8 (first chunk) + 24 valid
    g = pm.tcfg.num_code_groups
    made = {"n": 1}

    def fake_ar_steps(self, carry, n_steps, flags, *args):
        codes_seq, fins = [], []
        fin = bool(carry.finished[0])
        for _ in range(n_steps):
            if fin:
                break
            c = made["n"]
            fin = c >= K
            codes_seq.append(torch.full((1, g), c % 200 + 1))
            fins.append(torch.tensor([fin]))
            made["n"] += 1
            yield
        carry = dataclasses.replace(carry, finished=torch.tensor([fin]))
        return carry, codes_seq, fins

    monkeypatch.setattr(q.Model, "_ar_steps", fake_ar_steps)
    results = _stream(pm, text_ids=np.arange(10, 25)[None], temperature=0.0,
                      max_tokens=60, streaming_interval=2.0)
    total = sum(r.samples for r in results)
    assert total == K * pm.total_upsample, (
        f"expected {K} frames, got {total / pm.total_upsample}")
    assert results[-1].is_final_chunk


def test_stream_longer_than_its_codec_buffer_raises():
    """Departure from the JAX package: a stream whose frames would not fit
    the codec's stream KV buffer (STREAM_CACHE_LEN) raises instead of
    decoding corrupt late audio."""
    from mlx_audio_tpu_torch.tts.models.qwen3_tts.speech_tokenizer import (
        STREAM_CACHE_LEN)

    pm = _port("tiny")
    with pytest.raises(ValueError, match="4096"):
        _stream(pm, text_ids=np.arange(10, 25)[None],
                max_tokens=STREAM_CACHE_LEN + 1)
