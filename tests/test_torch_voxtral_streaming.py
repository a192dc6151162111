"""The port's Voxtral streaming against the JAX package, on the CPU at f32:
interleaved RoPE, the ring cache (`ring_update`, `ring_mask`) against full
attention, the ring-cached encoder step against the offline encoder, and
the live session (`feed`/`close`/`step`): its adapter frames, tokens and
text against the offline path and against JAX's session, EOS, incremental
feeds, and feeds from other threads.

The JAX package's model-level jit-cache test has no counterpart: eager
PyTorch traces nothing. Tensors agree within TOL (2e-4); tokens and text
are equal.
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402

from mlx_audio_tpu.ops import kvcache as jkv  # noqa: E402
from mlx_audio_tpu.stt.models.voxtral_realtime import voxtral_realtime as jvr  # noqa: E402
from test_torch_voxtral_realtime import (TOL, config_dict, model_pair,  # noqa: E402
                                         noise, write_tekken)


@pytest.fixture(scope="module")
def tekken(tmp_path_factory):
    return write_tekken(tmp_path_factory.mktemp("tekken") / "tekken.json",
                        " ")


@pytest.fixture(scope="module")
def pair(tekken):
    """tests/test_voxtral_streaming.py's config (window 48) at a 2-layer
    encoder."""
    return model_pair(config_dict(enc_layers=2, window=48), tekken)


def _drain(sess, max_decode_tokens, limit=500):
    """Step a closed session until done: (deltas, finals)."""
    deltas, finals = [], []
    for _ in range(limit):
        for ev in sess.step(max_decode_tokens=max_decode_tokens):
            (deltas if ev.kind == "delta" else finals).append(ev.text)
        if sess.done:
            break
    assert sess.done
    return deltas, finals


# ------------------------------------------------------------------ rope


@pytest.mark.parametrize("head_dim,rot", [(8, 8), (8, 4), (16, 12)])
def test_rope_interleaved_matches_jax(head_dim, rot):
    """Pairs (2j, 2j+1) rotate by angle j; dimensions past `rot` pass
    through unchanged; positions (T,) or (B, T)."""
    from mlx_audio_tpu.ops.rope import apply_rope_interleaved as jax_rope
    from mlx_audio_tpu_torch.ops.rope import apply_rope_interleaved, rope_freqs

    rs = np.random.RandomState(head_dim + rot)
    x = rs.randn(2, 5, 3, head_dim).astype(np.float32)
    inv = rope_freqs(rot, 1e6)
    for pos in (np.arange(7, 12), np.stack([np.arange(5), np.arange(3, 8)])):
        got = apply_rope_interleaved(torch.from_numpy(x),
                                     torch.from_numpy(pos), inv)
        want = np.asarray(jax_rope(jnp.asarray(x), jnp.asarray(pos),
                                   jnp.asarray(inv.numpy())))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
        np.testing.assert_array_equal(got.numpy()[..., rot:], x[..., rot:])


# ------------------------------------------------------------ ring cache


def test_ring_matches_full_attention():
    """Chunked ring-cache attention equals full band-masked attention, and
    the ring write and mask equal JAX's at every chunk."""
    from mlx_audio_tpu_torch.ops.attention import attention
    from mlx_audio_tpu_torch.ops.kvcache import KVCache, ring_mask, ring_update

    rs = np.random.RandomState(0)
    T, W, CAP, H, D, S = 96, 24, 48, 2, 4, 16   # cap >= window + chunk
    q, k, v = (torch.from_numpy(rs.randn(1, T, H, D).astype(np.float32))
               for _ in range(3))
    qi, kj = np.arange(T)[:, None], np.arange(T)[None, :]
    full = torch.from_numpy(np.where((kj <= qi) & (qi - kj < W), 0.0,
                                     -np.inf).astype(np.float32))[None, None]
    ref = attention(q, k, v, mask=full)
    cache = KVCache.init(1, CAP, H, D, dtype=torch.float32, n_layers=1)
    jcache = jkv.KVCache.init(1, CAP, H, D, dtype=jnp.float32)
    outs = []
    for s0 in range(0, T, S):
        c = ring_update(cache.layer(0), k[:, s0:s0 + S], v[:, s0:s0 + S], s0)
        jcache = jkv.ring_update(jcache, jnp.asarray(k[:, s0:s0 + S].numpy()),
                                 jnp.asarray(v[:, s0:s0 + S].numpy()),
                                 jnp.int32(s0))
        np.testing.assert_array_equal(c.k.numpy(), np.asarray(jcache.k))
        m = ring_mask(CAP, W, s0, S, S)
        np.testing.assert_array_equal(m.numpy(), np.asarray(jkv.ring_mask(
            CAP, W, jnp.int32(s0), jnp.int32(S), S)))
        outs.append(attention(q[:, s0:s0 + S], c.k, c.v, mask=m))
    torch.testing.assert_close(torch.cat(outs, 1), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("cap,window,offset,n_valid,q_len", [
    (8, 4, 0, 3, 3), (48, 24, 32, 16, 16), (1024, 750, 3000, 10, 64),
    (1024, 750, 0, 64, 64)])
def test_ring_mask_matches_jax_and_blocks_unwritten_slots(cap, window, offset,
                                                          n_valid, q_len):
    from mlx_audio_tpu_torch.ops.kvcache import ring_mask

    m = ring_mask(cap, window, offset, n_valid, q_len)
    want = np.asarray(jkv.ring_mask(cap, window, jnp.int32(offset),
                                    jnp.int32(n_valid), q_len))
    np.testing.assert_array_equal(m.numpy(), want)
    assert m.shape == (1, 1, q_len, cap)
    # every query keeps a key: a softmax over a row is never NaN
    assert torch.isfinite(m).any(-1).all()
    if offset == 0:
        assert torch.isneginf(m[0, 0, 0, n_valid:]).all()   # unwritten slots
        assert m[0, 0, n_valid - 1, n_valid - 1] == 0.0     # own position


# ------------------------------------------------------- streamed encoder


def test_chunked_ring_equals_offline(pair):
    """The ring-cached encoder step over ENC_CHUNK chunks (the last one
    partial) equals the offline encoder, the port's and JAX's (whose own
    streamed step tests/test_voxtral_streaming.py holds to it)."""
    from mlx_audio_tpu_torch.ops.kvcache import KVCache
    from mlx_audio_tpu_torch.stt.models.voxtral_realtime import (
        voxtral_realtime as pvr)
    from mlx_audio_tpu_torch.stt.models.voxtral_realtime.streaming import (
        ENC_CHUNK, encoder_stream_step)

    jm, pm = pair
    e = pm.config.encoder_args
    T = 160
    conv = (np.random.RandomState(1).randn(1, T, e.dim) * 0.1).astype(
        np.float32)
    ref = np.asarray(jvr.encoder_layers(jm.params["encoder"], e,
                                        jnp.asarray(conv), jnp.int32(T)))
    offline = pvr.encoder_layers(pm, torch.from_numpy(conv), T)
    np.testing.assert_allclose(offline.numpy(), ref, atol=TOL, rtol=0)
    caches = KVCache.init(1, 128, e.n_heads, e.head_dim, dtype=torch.float32,
                          n_layers=e.n_layers)
    outs = []
    for s0 in range(0, T, ENC_CHUNK):
        n = min(ENC_CHUNK, T - s0)
        x = torch.zeros(1, ENC_CHUNK, e.dim)
        x[0, :n] = torch.from_numpy(conv[0, s0:s0 + n])
        outs.append(encoder_stream_step(pm, x, caches, s0, n)[0, :n])
    np.testing.assert_allclose(torch.cat(outs).numpy(), ref[0], atol=TOL,
                               rtol=0)


# ---------------------------------------------------------------- session


def test_adapter_frames_match_offline(pair):
    """The session's adapter frames from uneven feeds equal offline
    `encode` (the port's, and JAX's, finite at this length) and JAX's
    session's."""
    jm, pm = pair
    audio = noise(2, 16000 * 3)
    padded = jvr._pad_audio_streaming(audio, 2, 2 + 11)
    offline, n_audio = pm.encode(padded)
    want, n_j = jm.encode(padded)
    assert n_j == n_audio and np.isfinite(want).all()
    np.testing.assert_allclose(offline.numpy(), want, atol=TOL, rtol=0)
    frames = []
    for m in (pm, jm):
        sess = m.create_streaming_session()
        for i in range(0, len(audio), 3000):
            sess.feed(audio[i:i + 3000])
        sess.close()
        sess.step(max_decode_tokens=0)
        got = sess._adapter_cat()
        frames.append(np.asarray(got)[:n_audio])
        assert got.shape[0] >= n_audio
    np.testing.assert_allclose(frames[0], offline[0].numpy(), atol=TOL,
                               rtol=0)
    np.testing.assert_allclose(frames[0], frames[1], atol=TOL, rtol=0)


@pytest.mark.parametrize("seconds,max_decode_tokens", [(1.0, 8), (2.3, 3)])
def test_session_matches_offline_and_jax(pair, seconds, max_decode_tokens):
    """The session's tokens, deltas and final event equal JAX's session's,
    and its tokens and text equal the offline decode's; exactly one final
    event carrying the full transcript, and `text` agrees."""
    jm, pm = pair
    audio = noise(3, int(16000 * seconds))
    off_tokens = [t for new, _, _ in pm._run(audio, 256, None) for t in new]
    off = pm.generate(audio, max_tokens=256)
    runs = []
    for m in (pm, jm):
        sess = m.create_streaming_session(max_tokens=256)
        sess.feed(audio)
        sess.close()
        runs.append(_drain(sess, max_decode_tokens) + (sess.generated,
                                                       sess.text))
    assert runs[0] == runs[1]
    deltas, finals, generated, text = runs[0]
    assert generated == off_tokens
    assert "".join(deltas).strip() == off.text
    assert finals == ["".join(deltas)] and text == "".join(deltas)


@pytest.mark.parametrize("eos", [34, 5])
def test_session_stops_at_eos_like_jax(tekken, eos):
    """A session reaching EOS mid-chunk keeps it in `generated`, stops, and
    gives JAX's tokens and events."""
    jm, pm = model_pair(config_dict(enc_layers=2, window=48, eos=eos),
                        tekken)
    audio = noise(1)
    runs = []
    for m in (pm, jm):
        sess = m.create_streaming_session(max_tokens=256)
        sess.feed(audio)
        sess.close()
        runs.append(_drain(sess, 5) + (sess.generated,))
    assert runs[0] == runs[1]
    assert runs[0][2][-1] == eos and runs[0][2].count(eos) == 1


def test_incremental_feed_same_as_bulk(pair):
    jm, pm = pair
    audio = noise(4, 12000)

    def run(feeds):
        s = pm.create_streaming_session(max_tokens=128)
        for f in feeds:
            s.feed(f)
        s.close()
        return "".join(_drain(s, 4)[0]), s.generated

    bulk = run([audio])
    assert bulk == run([audio[i:i + 777] for i in range(0, len(audio), 777)])
    assert bulk[1]


def test_feeds_from_other_threads_lose_no_samples(pair):
    """feed() from four threads while the owner steps: every sample fed is
    ingested once (the queue is under a lock)."""
    import sys

    _, pm = pair
    sess = pm.create_streaming_session(max_tokens=64)
    chunk = noise(5, 331)
    fed = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def feeder():
            for _ in range(60):
                sess.feed(chunk)
            fed.append(60 * len(chunk))

        threads = [threading.Thread(target=feeder) for _ in range(4)]
        for t in threads:
            t.start()
        for _ in range(20):
            sess.step(max_decode_tokens=1)
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    sess.step(max_decode_tokens=0)
    consumed = sess._mel_lead + len(sess._raw) - 200 - 2 * 1280
    assert len(fed) == 4 and consumed == sum(fed)
