"""The PyTorch port's continuous-batching session and broker, on the CPU at
float32: the seven tests of tests/test_continuous_batching.py on the port,
a greedy session against the JAX package's session, the port's two
departures from it, and three requests through the port's
`InferenceBroker`.

Model: the `tiny` variant of tests/test_torch_qwen3_tts.py (the JAX tiny
config with its tts ids inside the text vocabulary), built from one
parameter tree through `model.load_jax_params`. Audio tolerance: 1e-4
relative to its largest value, as the other Qwen3-TTS port tests.
"""

import queue
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401
from test_torch_qwen3_tts import AUDIO_REL, _jax_model, _port, _rel  # noqa: E402


@pytest.fixture(scope="module")
def model():
    return _port("tiny")


def _req(lo, hi):
    from mlx_audio_tpu_torch.server_inference import InferenceRequest

    return InferenceRequest(
        endpoint_kind="tts", model_name="m", payload=None,
        normalized_kwargs={"text_ids": np.arange(lo, hi)[None]})


def _opts(**kw):
    from mlx_audio_tpu_torch.tts.continuous import TTSBatchOptions

    return TTSBatchOptions(**kw)


def _drain(req):
    kinds, payloads = [], []
    while not req.result_queue.empty():
        c = req.result_queue.get()
        kinds.append(c.kind)
        payloads.append(c.payload)
    return kinds, payloads


def _audio(payloads):
    return np.concatenate(
        [p["audio"] for p in payloads if p and "audio" in p])


def _run(sess, steps=40):
    for _ in range(steps):
        sess.step()
        if sess.idle:
            break
    assert sess.idle


# ---------------------------------------------------------------------------
# tests/test_continuous_batching.py on the port
# ---------------------------------------------------------------------------


def test_two_requests_with_midstream_admission(model):
    sess = model.create_tts_batch_session(
        _opts(max_batch_size=2, max_tokens=16, streaming_interval=0.4))
    # streaming_interval 0.4 s at 12.5 Hz -> 5 frames per step
    assert sess.frames_per_step == 5
    r1 = _req(10, 25)
    sess.submit(r1)
    assert not sess.idle
    assert sess.available_slots == 1
    for _ in range(2):       # 1 (step 0) + 2 x 5 frames = 11 < max_tokens
        sess.step()
    r2 = _req(30, 42)
    sess.submit(r2)
    assert sess.available_slots == 0
    _run(sess)
    for r in (r1, r2):
        kinds, payloads = _drain(r)
        assert kinds[-1] == "done"
        assert "data" in kinds
        audio = _audio(payloads)
        assert len(audio) % model.total_upsample == 0
        assert np.isfinite(audio).all()


def test_cold_burst_admits_in_one_step(model):
    """With no live stream to protect, a burst is admitted in one batched
    prefill on the first step, and every request completes."""
    sess = model.create_tts_batch_session(
        _opts(max_batch_size=4, max_tokens=8, streaming_interval=0.4,
              admits_per_step=1))
    reqs = [_req(10 + i, 22 + i) for i in range(4)]
    for r in reqs:
        sess.submit(r)
    assert sess.available_slots == 0
    assert len(sess._admit_queue) == 4
    sess.step()
    assert len(sess._admit_queue) == 0   # cold burst: all admitted
    assert sum(bool(c) for c in sess.codes) == 4
    _run(sess)
    for r in reqs:
        kinds, payloads = _drain(r)
        assert kinds[-1] == "done"
        assert len(_audio(payloads)) % model.total_upsample == 0


def test_staggered_admission_with_live_streams(model):
    """Once a stream is live, later submissions are admitted
    admits_per_step at a time, and every request still completes."""
    sess = model.create_tts_batch_session(
        _opts(max_batch_size=4, max_tokens=12, streaming_interval=0.4,
              admits_per_step=1))
    first = _req(9, 21)
    sess.submit(first)
    sess.step()                      # admits and starts streaming row 0
    assert sum(bool(c) for c in sess.codes) == 1
    late = [_req(10 + i, 22 + i) for i in range(3)]
    for r in late:
        sess.submit(r)
    assert len(sess._admit_queue) == 3
    sess.step()
    assert len(sess._admit_queue) == 2   # exactly one admitted
    sess.step()
    assert len(sess._admit_queue) == 1
    _run(sess)
    for r in [first, *late]:
        kinds, payloads = _drain(r)
        assert kinds[-1] == "done"
        assert len(_audio(payloads)) % model.total_upsample == 0


def test_cancel_while_queued(model):
    """Cancelling a request still waiting for admission frees its slot
    without prefilling it."""
    sess = model.create_tts_batch_session(
        _opts(max_batch_size=2, max_tokens=8, admits_per_step=1))
    r1, r2 = _req(5, 15), _req(6, 16)
    sess.submit(r1)
    sess.submit(r2)
    sess.cancel(r2.request_id)
    _run(sess, 20)
    kinds, _ = _drain(r1)
    assert kinds[-1] == "done"
    assert _drain(r2) == ([], [])


def test_cancel_frees_slot(model):
    sess = model.create_tts_batch_session(
        _opts(max_batch_size=2, max_tokens=16))
    r = _req(5, 15)
    sess.submit(r)
    sess.cancel(r.request_id)
    assert sess.idle


def test_fail_emits_errors(model):
    sess = model.create_tts_batch_session(
        _opts(max_batch_size=2, max_tokens=16))
    r = _req(5, 15)
    sess.submit(r)
    sess.fail(RuntimeError("stopping"))
    kinds, _ = _drain(r)
    assert "error" in kinds and kinds[-1] == "done"
    assert sess.idle


def _single_stream(model, text_ids, max_tokens, interval):
    return np.concatenate([
        np.asarray(r.audio) for r in model.generate(
            text_ids=text_ids, temperature=0.0, repetition_penalty=1.0,
            max_tokens=max_tokens, stream=True,
            streaming_interval=interval)])


def test_greedy_session_matches_single_stream(model):
    """temperature 0: the session's audio equals the single-stream
    streamed audio (pins the KV splice's column layout, row-local RoPE,
    the trailing-embed advance and the pad embed). The JAX test allows
    rtol 2e-2; the port is held to 1e-4 relative."""
    text_ids = np.arange(10, 26)[None]
    single = _single_stream(model, text_ids, 12, 0.4)
    sess = model.create_tts_batch_session(
        _opts(max_batch_size=2, max_tokens=12, temperature=0.0,
              repetition_penalty=1.0, streaming_interval=0.4))
    req = _req(10, 26)
    sess.submit(req)
    _run(sess, 30)
    kinds, payloads = _drain(req)
    assert kinds[-1] == "done"
    batched = _audio(payloads)
    assert batched.shape == single.shape
    assert _rel(batched, single) <= AUDIO_REL


# ---------------------------------------------------------------------------
# against the JAX session
# ---------------------------------------------------------------------------


def _session_codes(sess):
    """Record each slot's codes as step() appends them."""
    seen = {}
    orig = type(sess)._decode_batch.__get__(sess)

    def decode(rows):
        for slot, _ in rows:
            seen[slot] = np.concatenate(sess.codes[slot], axis=0).copy()
        return orig(rows)

    sess._decode_batch = decode
    return seen


def test_greedy_session_matches_jax_session(model):
    """A greedy burst of three requests, one admitted mid-stream, on the
    port's session and on the JAX package's: equal codes per request, and
    equal audio chunk by chunk at 1e-4 relative."""
    from mlx_audio_tpu.server_inference import InferenceRequest as JReq
    from mlx_audio_tpu.tts.continuous import TTSBatchOptions as JOpts

    jm, _ = _jax_model("tiny")
    kw = dict(max_batch_size=3, max_tokens=14, temperature=0.0,
              repetition_penalty=1.0, streaming_interval=0.4,
              max_cache_len=256)
    results = []
    for m, opts, make in ((jm, JOpts(**kw), JReq), (model, _opts(**kw), None)):
        sess = m.create_tts_batch_session(opts)
        seen = _session_codes(sess)

        def req(lo, hi):
            if make is None:
                return _req(lo, hi)
            return make(endpoint_kind="tts", model_name="m", payload=None,
                        normalized_kwargs={"text_ids": np.arange(lo, hi)[None]})

        reqs = [req(10, 26), req(12, 30)]
        for r in reqs:
            sess.submit(r)
        sess.step()
        reqs.append(req(20, 33))
        sess.submit(reqs[-1])
        chunks = [[] for _ in reqs]
        for _ in range(30):
            sess.step()
            for i, r in enumerate(reqs):
                kinds, payloads = _drain(r)
                chunks[i] += [np.asarray(p["audio"]) for p in payloads
                              if p and "audio" in p]
            if sess.idle:
                break
        assert sess.idle
        results.append((chunks, seen))
    (jchunks, jcodes), (pchunks, pcodes) = results
    assert sorted(pcodes) == sorted(jcodes) == [0, 1, 2]
    for slot in jcodes:
        np.testing.assert_array_equal(pcodes[slot], jcodes[slot])
    for want, got in zip(jchunks, pchunks):
        assert [len(c) for c in got] == [len(c) for c in want]
        assert len(got) and _rel(np.concatenate(got),
                                 np.concatenate(want)) <= AUDIO_REL


# ---------------------------------------------------------------------------
# departures from the JAX session (ROADMAP.md section 3)
# ---------------------------------------------------------------------------


def test_session_streams_longer_than_the_codec_buffer_raise(model):
    """The JAX session caps the codec's stream KV at 4096 frames without a
    word (late audio is then corrupt); the port refuses such a session."""
    with pytest.raises(ValueError, match="4096"):
        model.create_tts_batch_session(
            _opts(max_batch_size=2, max_tokens=4096 - 9,
                  streaming_interval=0.4))
    sess = model.create_tts_batch_session(
        _opts(max_batch_size=2, max_tokens=4096 - 10,
              streaming_interval=0.4))
    assert sess.codec_state["tf_caches"][0].k.shape[1] == 4096


def test_session_audio_with_codec_biases_matches_decode_full():
    """With every codec bias drawn N(0, 0.1), a two-slot session that
    admits its second request mid-stream streams, for each request, the
    one-shot decode of that request's codes within 2e-4: the row-masked
    decode carries each transposed conv's overflow without its bias, as
    `streaming_step` does (the JAX session adds the bias twice on the
    overlap samples)."""
    from test_torch_qwen3_streaming import draw_codec_biases

    model = _port("tiny")
    draw_codec_biases(model, seed=1)
    sess = model.create_tts_batch_session(
        _opts(max_batch_size=2, max_tokens=14, temperature=0.0,
              repetition_penalty=1.0, streaming_interval=0.4,
              max_cache_len=256))
    seen = _session_codes(sess)
    reqs = [_req(10, 26), _req(30, 42)]
    sess.submit(reqs[0])
    sess.step()
    sess.submit(reqs[1])
    _run(sess)
    assert sorted(seen) == [0, 1]
    dec = model.speech_tokenizer.decoder
    for slot, req in enumerate(reqs):
        kinds, payloads = _drain(req)
        assert kinds[-1] == "done"
        codes = torch.from_numpy(seen[slot].T[None])   # (1, n_q, frames)
        with torch.no_grad():
            want = dec(codes)[0].numpy()
        got = _audio(payloads)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=2e-4)


def test_warm_session_does_not_repeat_its_random_draws(model):
    """The JAX session draws from fold_in(key, t) and reset_timeline sets t
    to 0, so a reused warm session repeats its draws. The port keeps one
    generator per session: two equal bursts on one warm session at
    temperature 0.9 give different codes."""
    sess = model.create_tts_batch_session(
        _opts(max_batch_size=2, max_tokens=10, temperature=0.9,
              streaming_interval=0.4, max_cache_len=256))
    bursts = []
    for _ in range(2):
        seen = _session_codes(sess)
        reqs = [_req(10, 26), _req(11, 27)]
        for r in reqs:
            sess.submit(r)
        _run(sess)
        for r in reqs:
            assert _drain(r)[0][-1] == "done"
        bursts.append(seen)
        sess.reset_timeline()
        assert sess.t == 0
    assert sorted(bursts[0]) == sorted(bursts[1]) == [0, 1]
    assert any(not np.array_equal(bursts[0][s], bursts[1][s]) for s in (0, 1))


def test_first_frame_eos_is_not_decoded(model, monkeypatch):
    """A request whose first sampled code 0 is EOS ends with `done` and no
    audio: the JAX session would feed that EOS id to the codec."""
    from mlx_audio_tpu_torch.tts.models.qwen3_tts import continuous_batching

    eos, vocab = model.tcfg.codec_eos_token_id, model.tcfg.vocab_size
    plain = continuous_batching.sample

    def sample(logits, *a, **kw):
        tok = plain(logits, *a, **kw)
        return torch.full_like(tok, eos) if logits.shape[-1] == vocab else tok

    monkeypatch.setattr(continuous_batching, "sample", sample)
    sess = model.create_tts_batch_session(
        _opts(max_batch_size=2, max_tokens=10, streaming_interval=0.4))
    r = _req(10, 26)
    sess.submit(r)
    _run(sess, 5)
    kinds, _ = _drain(r)
    assert kinds == ["done"]


# ---------------------------------------------------------------------------
# the broker
# ---------------------------------------------------------------------------


class _TTSAdapter:
    """The continuous-batch routing of the server's TTS adapter
    (mlx_audio_tpu/server.py:117-146), on one port model."""

    max_batch_size = 1

    def __init__(self, model, options):
        self.model, self.options = model, options

    def supports_batch(self, request):
        return False

    def batch_key(self, request):
        return None

    def supports_continuous_batch(self, request):
        return self.model.supports_tts_continuous_batch()

    def continuous_batch_key(self, request):
        return None

    def create_continuous_batch_session(self, request):
        sess = self.model.create_tts_batch_session(self.options)
        sess.warmup()
        return sess

    def run_serial(self, request):
        raise AssertionError("every request takes the session")


def test_broker_answers_three_requests(model):
    """Three requests through the port's InferenceBroker: its worker thread
    creates and warms one session, steps it, and every request ends with
    `done` after finite audio of whole frames."""
    from mlx_audio_tpu_torch.server_inference import InferenceBroker

    broker = InferenceBroker(idle_poll_s=0.01)
    try:
        broker.register_adapter("tts", _TTSAdapter(model, _opts(
            max_batch_size=4, max_tokens=10, streaming_interval=0.4,
            max_cache_len=256)))
        handles = [broker.submit(endpoint_kind="tts", model_name="m",
                                 payload=None,
                                 normalized_kwargs={"text_ids": np.arange(
                                     10 + i, 24 + i)[None]})
                   for i in range(3)]
        for h in handles:
            kinds, audio = [], []
            while not kinds or kinds[-1] != "done":
                c = h.result_queue.get(timeout=120)
                kinds.append(c.kind)
                if c.kind == "data":
                    audio.append(c.payload["audio"])
            assert "error" not in kinds and "data" in kinds
            a = np.concatenate(audio)
            assert len(a) % model.total_upsample == 0
            assert np.isfinite(a).all()
        assert threading.current_thread() is not broker._worker
    finally:
        broker.stop_and_join()
    with pytest.raises(queue.Empty):
        handles[0].result_queue.get_nowait()
