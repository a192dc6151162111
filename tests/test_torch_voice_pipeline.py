"""The voice pipeline and the audio players of the PyTorch port against the
JAX package, on the CPU: the cases of tests/test_voice_pipeline.py (VAD
hysteresis, a full turn, the smart-turn early end, noise ignored, echo
suppression and barge-in, the output stream's state and echo correlation)
and tests/test_voice_pipeline_llm.py (a tiny llama bound as the response
engine, alone and in a turn), each run through both packages on the same
scripted components, with equal events, equal echo-correlation numbers
and equal greedy replies; the departures pinned (a model without a
tokenizer raises; the decode reads its tokens a chunk at a time); the
wrappers over the port's Silero and Smart Turn.

The scripted components are tests/test_voice_pipeline.py's. The llama is
tests/test_voice_pipeline_llm.py's tiny config at PRNGKey(7), its tree
bound into the port by `model.load_jax_params`; replies are greedy.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401
from test_voice_pipeline import (FakeSmartTurn, FakeSTT, FakeTTS,  # noqa: E402
                                 ScriptedVad, frames)
from test_voice_pipeline_llm import CFG, CharTok  # noqa: E402


def _mods(pkg):
    if pkg == "jax":
        from mlx_audio_tpu.sts import audio_player, voice_pipeline
    else:
        from mlx_audio_tpu_torch.sts import audio_player, voice_pipeline
    return voice_pipeline, audio_player


# -- VAD hysteresis ---------------------------------------------------------

VAD_CASES = {
    "start_stop": ([0.1] * 3 + [0.9] * 5 + [0.1] * 40,
                   dict(min_silence_ms=600), 48),
    "candidate": ([0.9] * 3 + [0.1] * 40,
                  dict(min_silence_ms=600, candidate_silence_ms=120), 40),
    "flicker": ([0.9, 0.2, 0.5, 0.9, 0.3, 0.1, 0.1, 0.7] * 6,
                dict(min_silence_ms=96, candidate_silence_ms=32), 48),
}


@pytest.mark.parametrize("case", list(VAD_CASES))
def test_vad_hysteresis_equals_jax(case):
    """Frame by frame, (prob, started, stopped, candidate) equal JAX's."""
    probs, cfg, n = VAD_CASES[case]
    out = {}
    for pkg in ("jax", "port"):
        vp, _ = _mods(pkg)
        vad = vp.SileroVoiceActivityDetector(ScriptedVad(probs),
                                             vp.VadConfig(**cfg))
        out[pkg] = [vad.process(np.zeros(512, np.float32)) for _ in range(n)]
    assert out["port"] == out["jax"]
    events = [e for _, s, t, c in out["port"]
              for e, on in (("start", s), ("candidate", c), ("stop", t)) if on]
    assert "start" in events and "stop" in events


# -- pipeline turns -----------------------------------------------------------


def _clock():
    t = {"now": 100.0}
    return t, lambda: t["now"]


def _scenario(pkg, name):
    """Run scenario `name` through `pkg`'s pipeline -> (events, the fetched
    chunk lengths)."""
    vp, _ = _mods(pkg)
    events, fetched = [], []
    t, clock = _clock()
    kw = dict(min_silence_ms=300)
    st = None
    if name == "full_turn":
        probs = [0.0] * 2 + [0.9] * 10 + [0.0] * 30
    elif name in ("smart_turn_early", "smart_turn_incomplete"):
        st = FakeSmartTurn(complete=name == "smart_turn_early")
        probs = [0.0] * 2 + [0.9] * 10 + [0.0] * 10
        kw.update(min_silence_ms=10_000, candidate_silence_ms=96)
    elif name == "short_noise":
        probs = [0.0] * 40
    elif name == "echo":
        probs = [0.0] * 2 + [0.9] * 10 + [0.0] * 12 + [0.9] * 4 + [0.0] * 10
        kw.update(ignore_playback_echo_ms=500, echo_correlation_threshold=0.55)
    else:                                   # barge_in
        probs = [0.0] * 2 + [0.9] * 10 + [0.0] * 12 + [0.9] * 6 + [0.0] * 10
        kw.update(ignore_playback_echo_ms=500, echo_correlation_threshold=0.55)
    p = vp.VoicePipeline(vad_model=ScriptedVad(probs), stt_model=FakeSTT(),
                         tts_model=FakeTTS(), smart_turn_model=st,
                         on_event=lambda k, d: events.append((k, d)),
                         vad_config=vp.VadConfig(**kw), clock=clock)
    try:
        if name in ("echo", "barge_in"):
            p.feed_audio(frames(24, 0.1))
            chunk = p.fetch_speech(timeout=1.0)
            fetched.append(len(chunk))
            t["now"] += 0.100
            if name == "echo":
                echo = chunk[: 512 * 10].astype(np.float32)
                p._preroll = echo[:-512]
                p.feed_audio(echo[-512 * 4:])
            else:
                rng = np.random.RandomState(0)
                p._preroll = rng.randn(512 * 6).astype(np.float32)
                p.feed_audio(rng.randn(512 * 4).astype(np.float32))
        else:
            p.feed_audio(frames(len(probs), 0.1 if name != "short_noise"
                                else 0.0))
            while (chunk := p.fetch_speech()) is not None:
                fetched.append(len(chunk))
    finally:
        p.shutdown()
    if st is not None:
        events.append(("smart_turn_calls", st.calls))
    return events, fetched


SCENARIOS = {
    "full_turn": lambda kinds, ev, f: (
        {"speech_started", "speech_stopped", "transcription", "response"}
        <= set(kinds) and ev["response"]["text"].startswith("You said:")
        and f == [2400, 2400]),
    "smart_turn_early": lambda kinds, ev, f: (
        {"endpoint_candidate", "speech_stopped", "transcription"} <= set(kinds)
        and ev["smart_turn_calls"] == 1),
    "smart_turn_incomplete": lambda kinds, ev, f: (
        "speech_stopped" not in kinds and ev["smart_turn_calls"] == 1),
    "short_noise": lambda kinds, ev, f: kinds == [] and f == [],
    "echo": lambda kinds, ev, f: (
        "echo_suppressed" in kinds and "barge_in" not in kinds),
    "barge_in": lambda kinds, ev, f: (
        "barge_in" in kinds and "echo_suppressed" not in kinds),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_pipeline_events_equal_jax(name):
    """Each scenario's events (kinds and data, in order) and the chunks
    handed to the speaker equal JAX's, and meet the JAX test's checks."""
    port, fetched = _scenario("port", name)
    jax_events, jax_fetched = _scenario("jax", name)
    assert port == jax_events and fetched == jax_fetched
    kinds = [k for k, _ in port if k != "smart_turn_calls"]
    assert SCENARIOS[name](kinds, dict(port), fetched), port


# -- the output stream -----------------------------------------------------


def _streams(sig, now=10.0):
    out = {}
    for pkg in ("jax", "port"):
        _, ap = _mods(pkg)
        t = {"now": now}
        s = ap.AudioOutputStream(16000, clock=lambda t=t: t["now"])
        out[pkg] = (s, t)
    return out


def test_playback_state_equals_jax():
    """Before, while and after a chunk sounds, and after stop(): the state
    dicts equal JAX's."""
    streams = _streams(None)
    states = {k: [] for k in streams}
    for pkg, (s, t) in streams.items():
        states[pkg].append(s.playback_state())
        s.queue_audio(np.ones(1600, np.float32))
        s.queue_audio(np.ones(800, np.float32))
        states[pkg].append(s.playback_state())
        assert s.fetch_chunk().size == 1600
        states[pkg].append(s.playback_state())
        t["now"] += 0.2
        states[pkg].append(s.playback_state())
        s.stop()
        states[pkg].append(s.playback_state(now_ms=10500.0))
    assert states["port"] == states["jax"]
    assert states["port"][2]["last_output_age_ms"] < 0
    assert states["port"][1]["player_playing"]


@pytest.mark.parametrize("seed,delay_ms,noise", [
    (0, 100.0, 0.0), (1, 40.0, 0.1), (2, 260.0, 0.15), (3, 100.0, None)])
def test_echo_correlation_equals_jax(seed, delay_ms, noise):
    """`echo_correlation` on the stream's own output heard back `delay_ms`
    late (plus noise), or on unrelated noise (None): the same dict as
    JAX's, number for number; an echo is found near its delay."""
    rng = np.random.RandomState(seed)
    sig = np.cumsum(rng.randn(4800)).astype(np.float32)
    sig /= np.abs(sig).max()
    streams = _streams(sig)
    mic = (rng.randn(3200).astype(np.float32) if noise is None else
           sig[:3200] + noise * rng.randn(3200).astype(np.float32))
    res = {}
    for pkg, (s, t) in streams.items():
        s.queue_audio(sig)
        s.fetch_chunk()
        res[pkg] = s.echo_correlation(
            mic, input_sample_rate=16000,
            input_end_ms=10000.0 + delay_ms + 200.0, min_delay_ms=0.0,
            max_delay_ms=300.0, step_ms=25.0)
    assert res["port"] == res["jax"]
    if noise is None:
        assert res["port"]["correlation"] < 0.5
    else:
        assert res["port"]["correlation"] > 0.8
        assert abs(res["port"]["delay_ms"] - delay_ms) <= 25.0


def test_tts_audio_player_equals_jax():
    """The TTS player without sounddevice: a sink whose target buffer and
    drained audio equal JAX's."""
    from mlx_audio_tpu.tts.audio_player import AudioPlayer as JPlayer
    from mlx_audio_tpu_torch.tts.audio_player import AudioPlayer

    chunks = [np.full(n, i, np.float32) for i, n in
              enumerate((1000, 30000, 500))]
    out = []
    for cls in (JPlayer, AudioPlayer):
        p = cls(sample_rate=16000, min_buffer_seconds=1.0)
        p._sd = None
        for c in chunks:
            p.queue_audio(c)
        assert p.playing
        p.wait_for_drain()
        out.append(p.drain())
        p.stop()
    np.testing.assert_array_equal(out[0], out[1])
    assert out[1].size == 31500


# -- the LLM engine ---------------------------------------------------------


@pytest.fixture(scope="module")
def llm():
    """(JAX's TinyLM, the port's llama bound to its tree)."""
    from test_voice_pipeline_llm import TinyLM

    from mlx_audio_tpu.utils import flatten
    from mlx_audio_tpu_torch.model import load_jax_params
    from mlx_audio_tpu_torch.tts.models.llama import BackboneModel

    jm = TinyLM()
    flat = {k: np.asarray(v) for k, v in flatten(jm.params).items()}
    cfg = {k: getattr(CFG, k) for k in (
        "hidden_size", "num_hidden_layers", "intermediate_size",
        "num_attention_heads", "num_key_value_heads", "vocab_size",
        "head_dim", "rope_theta", "tie_word_embeddings", "rms_norm_eps")}
    return jm, load_jax_params(BackboneModel(cfg, device="cpu"), flat)


@pytest.mark.parametrize("text", ["hello there", "same prompt"])
def test_greedy_reply_equals_jax(llm, text):
    """A greedy reply of 12 tokens of the tiny llama to `text` after one
    user turn of history (the prompt a pipeline turn makes) equals JAX's,
    read a chunk of DECODE_CHUNK tokens at a time. (Both prompts have one
    length: JAX's eager engine compiles its ops for each length.)"""
    history, max_tokens = [{"role": "user", "content": text}], 12
    from mlx_audio_tpu.sts.voice_pipeline import LocalLLMResponseEngine as J
    from mlx_audio_tpu_torch.sts.voice_pipeline import (DECODE_CHUNK,
                                                        LocalLLMResponseEngine)

    jm, pm = llm
    want = J(jm, tokenizer=CharTok(), max_tokens=max_tokens,
             temperature=0.0).generate(text, history)
    eng = LocalLLMResponseEngine(pm, tokenizer=CharTok(),
                                 max_tokens=max_tokens, temperature=0.0)
    got = eng.generate(text, history)
    assert got == want and not got.startswith("You said:")
    run = eng.last_run
    assert run["reads"] <= -(-max_tokens // DECODE_CHUNK)
    assert run["tokens"] == len(got)


def test_eos_ends_the_reply_as_jax(llm, monkeypatch):
    """With the EOS id set to a token the greedy reply draws, the reply
    stops before it, as JAX's does, though the chunk ran past it."""
    from mlx_audio_tpu.sts.voice_pipeline import LocalLLMResponseEngine as J
    from mlx_audio_tpu_torch.sts.voice_pipeline import LocalLLMResponseEngine

    jm, pm = llm
    hist = [{"role": "user", "content": "hello there"}]
    full = LocalLLMResponseEngine(pm, tokenizer=CharTok(), max_tokens=12,
                                  temperature=0.0).generate("hello there",
                                                            hist)
    tok = CharTok()
    # the id behind the reply's fourth character
    eos = next(i for i in range(1, 64) if tok.decode([i]) == full[3])
    tok.eos_token_id = eos
    want = J(jm, tokenizer=tok, max_tokens=12,
             temperature=0.0).generate("hello there", hist)
    eng = LocalLLMResponseEngine(pm, tokenizer=tok, max_tokens=12,
                                 temperature=0.0)
    got = eng.generate("hello there", hist)
    assert got == want and len(got) <= 3
    assert eng.last_run["reads"] == 1


def test_sampled_reply_is_seeded(llm):
    """Sampled replies draw from a generator seeded 0: the same reply
    twice."""
    from mlx_audio_tpu_torch.sts.voice_pipeline import LocalLLMResponseEngine

    _, pm = llm
    eng = LocalLLMResponseEngine(pm, tokenizer=CharTok(), max_tokens=10,
                                 temperature=0.7)
    a = eng.generate("hi", [])
    assert a == eng.generate("hi", []) and len(a) > 0


def test_echo_fallback_and_missing_tokenizer(llm):
    """No model: the documented echo, as JAX's. A model without a
    tokenizer raises (a departure: JAX echoes as if no model were
    bound)."""
    from mlx_audio_tpu.sts.voice_pipeline import LocalLLMResponseEngine as J
    from mlx_audio_tpu_torch.sts.voice_pipeline import LocalLLMResponseEngine

    jm, pm = llm
    assert LocalLLMResponseEngine(None).generate("hi", []) == \
        J(None).generate("hi", []) == "You said: hi"
    assert J(jm).generate("hi", []) == "You said: hi"
    with pytest.raises(ValueError, match="tokenizer"):
        LocalLLMResponseEngine(pm).generate("hi", [])


def test_turn_with_the_lm_equals_jax(llm):
    """A whole turn with the tiny llama bound (the transcript "hello
    there"): the response event equals JAX's, and the TTS chunks reach the
    speaker."""
    jm, pm = llm

    class HelloSTT:
        def generate(self, audio, **kw):
            return FakeSTT().generate(audio[:11]).__class__(
                text="hello there")

    out = []
    for pkg, model in (("jax", jm), ("port", pm)):
        vp, _ = _mods(pkg)
        events = []
        p = vp.VoicePipeline(
            vad_model=ScriptedVad([0.0] * 2 + [0.9] * 10 + [0.0] * 30),
            stt_model=HelloSTT(), tts_model=FakeTTS(),
            llm_engine=vp.LocalLLMResponseEngine(
                model, tokenizer=CharTok(), max_tokens=12, temperature=0.0),
            on_event=lambda k, d: events.append((k, d)),
            vad_config=vp.VadConfig(min_silence_ms=300))
        p.feed_audio(frames(42, 0.1))
        chunk = p.fetch_speech(timeout=1.0)
        p.shutdown()
        out.append(events)
        assert chunk is not None and len(chunk) == 2400
    assert out[0] == out[1]
    resp = [d for k, d in out[1] if k == "response"]
    assert resp and not resp[0]["text"].startswith("You said:")


# -- the wrappers over the port's models -------------------------------------


def test_wrappers_over_the_ports_silero_and_smart_turn():
    """`SileroVoiceActivityDetector` reads the port's Silero `feed` (a
    tensor) and carries its state; `SmartTurnEndpointDetector` returns the
    port's Smart Turn decision."""
    from mlx_audio_tpu_torch.sts.voice_pipeline import (
        SileroVoiceActivityDetector, SmartTurnEndpointDetector, VadConfig)
    from mlx_audio_tpu_torch.vad.models.silero_vad import Model as SileroVAD
    from mlx_audio_tpu_torch.vad.models.silero_vad import ModelConfig
    from mlx_audio_tpu_torch.vad.models.smart_turn import Model as SmartTurn

    vad_model = SileroVAD(ModelConfig(), device="cpu").init_params(seed=0)
    det = SileroVoiceActivityDetector(vad_model, VadConfig())
    audio = np.random.RandomState(0).randn(512 * 3).astype(np.float32) * 0.1
    state = None
    for i in range(3):
        prob, *_ = det.process(audio[512 * i: 512 * (i + 1)])
        want, state = vad_model.feed(audio[512 * i: 512 * (i + 1)], state)
        assert prob == float(want.reshape(-1)[0])
    cfg = dict(encoder_config=dict(num_mel_bins=20, max_source_positions=50,
                                   d_model=16, encoder_attention_heads=2,
                                   encoder_layers=2, encoder_ffn_dim=32),
               processor_config=dict(max_audio_seconds=1, n_mels=20))
    st = SmartTurn(cfg, device="cpu").init_params(seed=0)
    d = SmartTurnEndpointDetector(st, threshold=0.5).predict(audio)
    ref = st.predict_endpoint(audio, sample_rate=16000, threshold=0.5)
    assert (d.complete, d.probability) == (bool(ref.prediction),
                                           ref.probability)
