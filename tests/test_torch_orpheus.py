"""Orpheus (the llama token-TTS over SNAC) of the PyTorch port against the
JAX package, on the CPU: the cases of tests/test_orpheus.py (code
interleave, slot offsets, parse, prompts and the zeroprompt, generate
whole, streamed and by segments), each held to the JAX package's: greedy
tokens equal, audio within ATOL with the port's SNAC handed JAX's noise
draws; then the port's own rules (a seeded sampled run, the stop on either
EOS, a strict `post_load_hook`) and its entry points (the `load_model`
router, the TTS CLI's WAV, the server's /v1/audio/speech).

Config: tests/test_orpheus.py's (a 2-layer llama at d32, the full
156,938-id vocabulary, its tiny SNAC), one parameter set drawn with numpy
over JAX's shapes (`test_torch_mimi.numpy_params`). Audio at ATOL = 2e-4
(f32, summation order).
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401
from test_torch_mimi import flat_numpy, numpy_params  # noqa: E402
from test_torch_prequantized import no_hf_tokenizer  # noqa: E402,F401
from test_torch_snac import TINY as SNAC_TINY  # noqa: E402
from test_torch_snac import make_pair, torch_checkpoint  # noqa: E402

ATOL = 2e-4
CODE_OFFSET = 128266
CFG = dict(model_type="llama", hidden_size=32, num_hidden_layers=2,
           intermediate_size=64, num_attention_heads=4, num_key_value_heads=2,
           vocab_size=CODE_OFFSET + 7 * 4096, rope_theta=10000.0)


class FakeTok:
    eos_token_id = 128001

    def encode(self, text):
        return [ord(c) % 100 + 10 for c in text]


@pytest.fixture(scope="module")
def models():
    """(JAX Orpheus, port Orpheus) on one weight set, each with FakeTok and
    the tiny SNAC pair bound (the port's fed JAX's noise)."""
    from mlx_audio_tpu.tts.models.llama import Model as JModel
    from mlx_audio_tpu.tts.models.llama import ModelConfig as JConfig
    from mlx_audio_tpu_torch.model import load_jax_params
    from mlx_audio_tpu_torch.tts.models.llama import Model, ModelConfig

    jm = JModel(JConfig.from_dict(CFG))
    jm.bind(numpy_params(jm.init_params, 0))
    pm = load_jax_params(Model(ModelConfig.from_dict(CFG), device="cpu"),
                         flat_numpy(jm.params))
    js, ps = make_pair(noise=True, seed=1)
    jm._tokenizer = pm.tokenizer = FakeTok()
    jm._codec = js
    pm.set_codec(ps)
    return jm, pm


# ---------------------------------------------------------------------------
# codes and prompts
# ---------------------------------------------------------------------------


def test_interleave_equals_jax():
    from mlx_audio_tpu.tts.models.llama import orpheus as jo
    from mlx_audio_tpu_torch.tts.models.llama import orpheus as po

    rng = np.random.RandomState(0)
    layers = [rng.randint(0, 4096, (1, 5)), rng.randint(0, 4096, (1, 10)),
              rng.randint(0, 4096, (1, 20))]
    flat = po.layers_to_flat_codes(layers)
    np.testing.assert_array_equal(flat, jo.layers_to_flat_codes(layers))
    for a, b in zip(po.flat_codes_to_layers(flat), layers):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        po.layers_to_flat_codes([np.array([[7]]), np.array([[1, 2]]),
                                 np.array([[3, 4, 5, 6]])]),
        [7, 1 + 4096, 3 + 2 * 4096, 4 + 3 * 4096, 2 + 4 * 4096,
         5 + 5 * 4096, 6 + 6 * 4096])
    assert (po.SOH, po.EOT, po.EOH, po.SOA, po.SOS, po.EOS_SPEECH, po.EOA,
            po.CODE_OFFSET, po.CHUNK, po.PROMPT_BUCKETS, po.REP_WINDOW,
            po.TOKENS_PER_SECOND) == (
        jo.SOH, jo.EOT, jo.EOH, jo.SOA, jo.SOS, jo.EOS_SPEECH, jo.EOA,
        jo.CODE_OFFSET, jo.CHUNK, jo.PROMPT_BUCKETS, jo.REP_WINDOW,
        jo.TOKENS_PER_SECOND)


def test_parse_codes_equals_jax():
    from mlx_audio_tpu.tts.models.llama.orpheus import Model as JModel
    from mlx_audio_tpu_torch.tts.models.llama import orpheus as po

    codes = list(range(CODE_OFFSET, CODE_OFFSET + 14))
    toks = [po.SOH, 42, po.EOT, po.EOH, po.SOA, po.SOS] + codes + [
        po.EOS_SPEECH]
    for t in (toks, toks + [po.SOS] + codes[:10], codes[:9], []):
        np.testing.assert_array_equal(po.Model.parse_codes(t),
                                      JModel.parse_codes(t))
    np.testing.assert_array_equal(po.Model.parse_codes(toks), np.arange(14))


def test_prompts_equal_jax(models):
    """Plain and voiced prompts, and the zeroprompt from a reference clip
    (its codes by the two SNACs' encoders)."""
    jm, pm = models
    for voice in (None, "tara"):
        np.testing.assert_array_equal(pm.prepare_input_ids("hi", voice),
                                      jm.prepare_input_ids("hi", voice))
    ref = np.random.RandomState(0).randn(16 * 20).astype(np.float32)
    zp = pm.prepare_zeroprompt(ref, "ref")
    assert zp == jm.prepare_zeroprompt(ref, "ref")
    assert zp[-2:] == [128258, 128262]
    ids = pm.prepare_input_ids("hi", voice="tara", zeroprompt=zp)
    assert list(ids[:len(zp)]) == zp


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------


def _tokens(m, ids, n, temperature=0.0, seed=0, **kw):
    *_, toks = m._decode_tokens(ids, n, temperature, kw.get("top_p", 0.8),
                                kw.get("top_k", 0), kw.get("rep", 1.3), seed)
    return toks


def test_greedy_generate_equals_jax(models):
    """Greedy tokens over two chunks, and the audio of `generate`."""
    jm, pm = models
    ids = jm.prepare_input_ids("hello world", voice="tara")
    assert _tokens(pm, ids, 40) == _tokens(jm, ids, 40)
    assert pm.last_run["chunks"] == 2 and pm.last_run["steps"] == 40
    kw = dict(voice="tara", max_tokens=21, temperature=0.0)
    (jr,) = list(jm.generate("hello world", **kw))
    (pr,) = list(pm.generate("hello world", **kw))
    assert pr.samples == jr.samples > 0 and pr.sample_rate == 24000
    np.testing.assert_allclose(pr.audio, np.asarray(jr.audio), atol=ATOL)


def test_streamed_equals_jax_and_offline(models):
    """`stream=True` every 0.1 s (13 tokens): the chunks equal JAX's, and
    `stream_generate` is the same stream."""
    jm, pm = models
    kw = dict(max_tokens=60, temperature=0.0, streaming_interval=0.1)
    jout = list(jm.generate("hello world streaming", stream=True, **kw))
    pout = list(pm.stream_generate("hello world streaming", **kw))
    assert len(pout) == len(jout) > 1
    for p, j in zip(pout, jout):
        assert p.token_count == j.token_count
        np.testing.assert_allclose(p.audio, np.asarray(j.audio), atol=ATOL)
    (whole,) = list(pm.generate("hello world streaming", **kw))
    assert sum(r.samples for r in pout) > 0 and whole.samples > 0


def test_segments_equal_jax(models):
    jm, pm = models
    kw = dict(max_tokens=20, temperature=0.0, seed=2)
    jout = list(jm.generate("one\ntwo", **kw))
    pout = list(pm.generate("one\ntwo", **kw))
    assert [r.segment_idx for r in pout] == [r.segment_idx for r in jout] \
        == [0, 1]
    for p, j in zip(pout, jout):
        np.testing.assert_allclose(p.audio, np.asarray(j.audio), atol=ATOL)


def test_sampled_run_is_seeded_and_keeps_the_rules(models):
    """A sampled run repeats under its seed; top_k 1 draws the greedy
    tokens; the repetition penalty's window and the stop still apply."""
    _, pm = models
    ids = pm.prepare_input_ids("sampled")
    a = _tokens(pm, ids, 10, temperature=0.6, seed=3)
    assert a == _tokens(pm, ids, 10, temperature=0.6, seed=3)
    assert len(a) == 10 and all(0 <= t < CFG["vocab_size"] for t in a)
    assert _tokens(pm, ids, 10, temperature=0.9, top_k=1) == _tokens(
        pm, ids, 10)


@pytest.mark.parametrize("stop", [128258, 128001])
def test_stops_on_either_eos(models, monkeypatch, stop):
    """EOS_SPEECH or the tokenizer's EOS ends the request: the stop token
    and everything after it are dropped, and no chunk runs after the one
    that drew it."""
    from mlx_audio_tpu_torch.tts.models.llama import orpheus

    _, pm = models
    real = orpheus.sample
    calls = []

    def forced(logits, *a, **kw):
        calls.append(1)
        tok = real(logits, *a, **kw)
        return torch.full_like(tok, stop) if len(calls) == 5 else tok

    monkeypatch.setattr(orpheus, "sample", forced)
    ids = pm.prepare_input_ids("stop")
    toks = _tokens(pm, ids, 100)
    assert len(toks) == 4 and stop not in toks
    assert pm.last_run["chunks"] == 1 and pm.last_run["steps"] == 32


# ---------------------------------------------------------------------------
# loading and the entry points
# ---------------------------------------------------------------------------


def write_orpheus_checkpoint(models, path, vocab=None):
    """The dense tiny Orpheus under HF names (`model.*`, `lm_head`) with a
    torch-layout SNAC in `snac/`; `vocab` keeps that many ids."""
    from safetensors.numpy import save_file

    from mlx_audio_tpu.utils import flatten

    jm, _ = models
    path.mkdir(parents=True)
    flat = {k: np.asarray(v) for k, v in flatten(jm.params).items()}
    if vocab is not None:
        for k in ("model.embed_tokens.weight", "lm_head.weight"):
            flat[k] = np.ascontiguousarray(flat[k][:vocab])
    save_file(flat, str(path / "model.safetensors"))
    (path / "config.json").write_text(json.dumps(
        dict(CFG, vocab_size=vocab or CFG["vocab_size"])))
    (path / "snac").mkdir()
    save_file(torch_checkpoint(flat_numpy(jm._codec.params), "weight_g"),
              str(path / "snac" / "model.safetensors"))
    (path / "snac" / "config.json").write_text(json.dumps(
        dict(SNAC_TINY, model_type="snac")))
    return path


@pytest.mark.parametrize("model_type", ["llama", "orpheus", "svara"])
def test_router_loads_orpheus(models, tmp_path, monkeypatch, model_type):
    from mlx_audio_tpu_torch import load_model
    from mlx_audio_tpu_torch.tts.models.llama import Model, orpheus

    monkeypatch.setattr(orpheus, "local_tokenizer", lambda p: FakeTok())
    d = write_orpheus_checkpoint(models, tmp_path / "ckpt")
    (d / "config.json").write_text(json.dumps(dict(CFG,
                                                   model_type=model_type)))
    m = load_model(d, device="cpu")
    assert type(m) is Model and m.codec is not None
    assert isinstance(m.tokenizer, FakeTok)
    for k, v in models[1].state_dict().items():
        assert torch.equal(m.state_dict()[k], v), k


def test_post_load_hook_raises_on_a_broken_codec(models, tmp_path):
    """JAX's `post_load_hook` swallows a codec that fails to load
    (orpheus.py:389-398) and `generate` fails later; the port's raises at
    load."""
    from mlx_audio_tpu.tts.utils import load_model as jax_load
    from mlx_audio_tpu_torch.tts.utils import load_model

    d = write_orpheus_checkpoint(models, tmp_path / "broken", vocab=1024)
    (d / "snac" / "model.safetensors").unlink()
    assert jax_load(d)._codec is None
    with pytest.raises(FileNotFoundError, match="No weight files"):
        load_model(d, device="cpu")


def test_tts_cli_wav_equals_generate(models, tmp_path, monkeypatch):
    """The TTS CLI on the checkpoint with --voice writes the in-process
    `generate`'s audio (16-bit WAV); --ref_audio with --ref_text builds the
    zeroprompt; --stream with --save writes the streamed chunks."""
    from mlx_audio_tpu_torch import audio_io
    from mlx_audio_tpu_torch.tts.generate import main
    from mlx_audio_tpu_torch.tts.models.llama import orpheus
    from mlx_audio_tpu_torch.tts.utils import load_model

    monkeypatch.setattr(orpheus, "local_tokenizer", lambda p: FakeTok())
    d = write_orpheus_checkpoint(models, tmp_path / "ckpt")
    ref = (np.random.RandomState(6).randn(640) * 0.3).astype(np.float32)
    audio_io.write(str(tmp_path / "ref.wav"), ref, 24000)
    common = ["--model", str(d), "--temperature", "0", "--max_tokens", "30",
              "--seed", "0", "--device", "cpu", "--no-verbose"]
    main(common + ["--text", "hi", "--voice", "tara", "--output_path",
                   str(tmp_path / "v")])
    main(common + ["--text", "hi", "--ref_audio", str(tmp_path / "ref.wav"),
                   "--ref_text", "words", "--output_path",
                   str(tmp_path / "c")])
    main(common + ["--text", "hi", "--stream", "--streaming_interval",
                   "0.1", "--save", "--output_path", str(tmp_path / "s")])
    model = load_model(d, device="cpu")
    kw = dict(temperature=0.0, max_tokens=30, seed=0, top_p=0.9, top_k=50,
              repetition_penalty=1.0)
    from mlx_audio_tpu_torch.utils import load_audio

    for out, gen in (("v", dict(voice="tara")),
                     ("c", dict(ref_audio=load_audio(
                         str(tmp_path / "ref.wav"), 24000),
                         ref_text="words"))):
        (want,) = [r.audio for r in model.generate("hi", **kw, **gen)]
        got, sr = audio_io.read(str(tmp_path / out / "audio_000.wav"),
                                dtype="float32")
        assert sr == 24000 and len(got) == len(want)
        np.testing.assert_allclose(got, np.clip(want, -1, 1),
                                   atol=2 / 32768)
    assert list((tmp_path / "s").glob("audio_*.wav"))


def test_server_speech_equals_generate(models, tmp_path, monkeypatch):
    """/v1/audio/speech through `AudioServer` on the checkpoint directory:
    the WAV body is the model's own `generate` audio."""
    import asyncio
    import io

    from mlx_audio_tpu_torch import audio_io
    from mlx_audio_tpu_torch.server import AudioServer
    from mlx_audio_tpu_torch.tts.models.llama import orpheus

    monkeypatch.setattr(orpheus, "local_tokenizer", lambda p: FakeTok())
    d = write_orpheus_checkpoint(models, tmp_path / "orpheus-tiny")
    server = AudioServer(device="cpu")
    body = {"model": str(d), "input": "hi", "voice": "tara",
            "temperature": 0.0, "max_tokens": 30, "response_format": "wav"}
    reply = asyncio.run(server.speech(body))
    data = asyncio.run(reply.read()) if asyncio.iscoroutinefunction(
        reply.read) else reply.read()
    got, sr = audio_io.read(io.BytesIO(data), dtype="float32")
    model = server.provider.get_cached(str(d))
    (want,) = [r.audio for r in model.generate(
        "hi", voice="tara", temperature=0.0, max_tokens=30)]
    assert sr == 24000 and len(got) == len(want)
    np.testing.assert_allclose(got, np.clip(want, -1, 1), atol=2 / 32768)
