"""The port's STT entry points against the JAX package, on the CPU: its
copy of `audio_io`, `stt.utils.load_model` and the category routing of
`mlx_audio_tpu_torch.load_model`, and the STT CLI (`stt/generate.py`), on
Whisper, on Voxtral Realtime and on Cohere ASR.

A tiny Whisper checkpoint (`tests/test_whisper.py::DIMS`, the JAX model's
random parameters under HF names, config.json in HF keys, npz) is written
once and loaded by both packages. Text, srt and vtt outputs must be equal
byte for byte; the json output equal but for the float fields that carry
the two packages' f32 rounding (`avg_logprob`, `no_speech_prob`), held to
1e-4. A tiny Voxtral Realtime checkpoint (tests/test_voxtral_realtime.py's
config, the JAX model's random parameters under mistral's consolidated
names, a tekken.json; `chip_smoke.py::write_voxtral_checkpoint`) is loaded
by both packages too: its transcription files must be equal byte for byte.
So must a tiny Cohere ASR checkpoint's (tests/test_cohere_asr.py's config,
the JAX model's random parameters under NeMo's names in torch's conv
layouts, npz, a tokens.json; `chip_smoke.py::write_cohere_checkpoint`).
"""

import io
import json
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from test_torch_whisper import checkpoint_trees  # noqa: E402
from test_whisper import DIMS  # noqa: E402

FLOAT_TOL = 1e-4


# ---------------------------------------------------------------------------
# audio_io
# ---------------------------------------------------------------------------


def _signal(channels, dtype):
    x = np.random.RandomState(channels).randn(1600, channels) * 0.3
    x = x[:, 0] if channels == 1 else x
    if dtype == "int16":
        return np.clip(np.round(x * 32768), -32768, 32767).astype(np.int16)
    return x.astype(dtype)


@pytest.mark.parametrize("dtype", ["float32", "float64", "int16"])
@pytest.mark.parametrize("channels", [1, 2])
def test_wav_round_trip_matches_jax(channels, dtype):
    from mlx_audio_tpu import audio_io as jax_io
    from mlx_audio_tpu_torch import audio_io

    data = _signal(channels, dtype)
    got, want = io.BytesIO(), io.BytesIO()
    audio_io.write(got, data, 16000)
    jax_io.write(want, data, 16000)
    assert got.getvalue() == want.getvalue()
    for kw in (dict(), dict(dtype="float32"), dict(dtype="int16"),
               dict(always_2d=True), dict(nchannels=1),
               dict(sample_rate=24000), dict(nchannels=2, sample_rate=8000)):
        a, ra = audio_io.read(io.BytesIO(got.getvalue()), **kw)
        b, rb = jax_io.read(io.BytesIO(want.getvalue()), **kw)
        assert ra == rb and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _wav_bytes(fmt_tag, bits, payload, nch=1, rate=16000):
    block = nch * bits // 8
    return (b"RIFF" + struct.pack("<I", 36 + len(payload)) + b"WAVE"
            + b"fmt " + struct.pack("<IHHIIHH", 16, fmt_tag, nch, rate,
                                    rate * block, block, bits)
            + b"data" + struct.pack("<I", len(payload)) + payload)


@pytest.mark.parametrize("fmt_tag,bits", [(1, 8), (1, 24), (1, 32), (3, 32),
                                          (3, 64)])
def test_wav_decode_matches_jax(fmt_tag, bits):
    from mlx_audio_tpu import audio_io as jax_io
    from mlx_audio_tpu_torch import audio_io

    payload = np.random.RandomState(bits).randint(
        0, 256, size=3 * 8 * 50, dtype=np.uint8).tobytes()
    if fmt_tag == 3:
        payload = np.random.RandomState(0).randn(150).astype(
            np.float32 if bits == 32 else np.float64).tobytes()
    data = _wav_bytes(fmt_tag, bits, payload)
    a, ra = audio_io._decode_wav(data)
    b, rb = jax_io._decode_wav(data)
    assert ra == rb
    np.testing.assert_array_equal(a, b)
    assert audio_io.detect_format(data) == jax_io.detect_format(data) == "wav"


def test_bad_audio_raises_like_jax():
    from mlx_audio_tpu import audio_io as jax_io
    from mlx_audio_tpu_torch import audio_io

    for bad in (b"not audio at all", b"RIFF\x00\x00\x00\x00WAVEjunk"):
        with pytest.raises(ValueError) as got:
            audio_io.read(io.BytesIO(bad))
        with pytest.raises(ValueError) as want:
            jax_io.read(io.BytesIO(bad))
        assert str(got.value) == str(want.value)


def test_load_audio_mixes_and_resamples_like_jax(tmp_path):
    from mlx_audio_tpu.utils import load_audio as jax_load_audio
    from mlx_audio_tpu_torch import audio_io
    from mlx_audio_tpu_torch.utils import load_audio

    path = tmp_path / "stereo.wav"
    audio_io.write(path, _signal(2, "float32"), 22050)
    got = load_audio(str(path), sample_rate=16000)
    want = np.asarray(jax_load_audio(str(path), sample_rate=16000))
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# load_model
# ---------------------------------------------------------------------------


def _hf_config(**extra):
    return dict(model_type="whisper", d_model=DIMS.n_audio_state,
                encoder_layers=DIMS.n_audio_layer,
                decoder_layers=DIMS.n_text_layer,
                encoder_attention_heads=DIMS.n_audio_head,
                decoder_attention_heads=DIMS.n_text_head,
                num_mel_bins=DIMS.n_mels, vocab_size=DIMS.n_vocab,
                max_source_positions=DIMS.n_audio_ctx,
                max_target_positions=DIMS.n_text_ctx, **extra)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A tiny Whisper checkpoint directory (HF names and config, npz) and
    the JAX package's model loaded from it."""
    from mlx_audio_tpu.stt.models.whisper import Model as JaxModel
    from mlx_audio_tpu.stt.utils import load_model as jax_load_model
    from mlx_audio_tpu.utils import flatten

    jm = JaxModel(DIMS).init_and_bind()
    hf, _ = checkpoint_trees({k: np.asarray(v)
                              for k, v in flatten(jm.params).items()})
    path = tmp_path_factory.mktemp("whisper-tiny")
    (path / "config.json").write_text(json.dumps(_hf_config()))
    np.savez(path / "weights.npz", **hf)
    return path, jax_load_model(path)


@pytest.fixture(scope="module")
def wav(tmp_path_factory):
    from mlx_audio_tpu_torch import audio_io

    path = tmp_path_factory.mktemp("audio") / "noise.wav"
    audio_io.write(path, (np.random.RandomState(9).randn(16000 * 5) * 0.05
                          ).astype(np.float32), 16000)
    return path


def test_load_model_matches_jax(checkpoint):
    from mlx_audio_tpu_torch.stt.models.whisper import Model
    from mlx_audio_tpu_torch.stt.utils import load_model

    path, jm = checkpoint
    pm = load_model(path, device="cpu")
    assert isinstance(pm, Model) and pm.device.type == "cpu"
    mel = np.random.RandomState(0).randn(1, 200, 80).astype(np.float32) * 0.1
    np.testing.assert_allclose(pm.embed_audio(mel).numpy(),
                               np.asarray(jm.embed_audio(mel)), atol=2e-4,
                               rtol=0)


def test_top_level_load_model_routes_stt_types(checkpoint, tmp_path):
    import mlx_audio_tpu_torch
    from mlx_audio_tpu_torch.stt.models.whisper import Model

    path, _ = checkpoint
    assert isinstance(mlx_audio_tpu_torch.load_model(path, device="cpu"),
                      Model)
    # no model_type: the directory's name says whisper
    named = tmp_path / "whisper-tiny"
    named.mkdir()
    cfg = _hf_config()
    del cfg["model_type"]
    (named / "config.json").write_text(json.dumps(cfg))
    (named / "weights.npz").write_bytes((path / "weights.npz").read_bytes())
    assert isinstance(mlx_audio_tpu_torch.load_model(named, device="cpu"),
                      Model)


@pytest.mark.parametrize("model_type", ["parakeet", "canary",
                                        "wav2vec2"])
def test_unported_stt_type_raises_a_clear_error(tmp_path, model_type):
    import mlx_audio_tpu_torch
    from mlx_audio_tpu_torch.stt.utils import load_model

    (tmp_path / "config.json").write_text(json.dumps(
        {"model_type": model_type}))
    for load in (load_model, mlx_audio_tpu_torch.load_model):
        with pytest.raises(ValueError, match="not ported.*ported: whisper, "
                           "voxtral_realtime, cohere_asr"):
            load(tmp_path, device="cpu")


def test_stt_remapping_is_the_jax_registry():
    from mlx_audio_tpu.stt.utils import MODEL_REMAPPING as JAX_REMAPPING
    from mlx_audio_tpu_torch.stt.utils import MODEL_REMAPPING

    assert MODEL_REMAPPING == JAX_REMAPPING


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_dash_and_underscore_aliases():
    from mlx_audio_tpu_torch.stt.generate import parse_args

    a = parse_args(["--model", "m", "--audio", "x.wav",
                    "--output-path", "o", "--max-tokens", "64",
                    "--chunk-duration", "20", "--frame-threshold", "25",
                    "--prefill-step-size", "1024",
                    "--max-parallel-segments", "4",
                    "--gen-kwargs", '{"beam_size": 5}',
                    "--context", "names", "--prompt", "p",
                    "--text", "align me", "--stream"])
    assert a.output_path == "o" and a.max_tokens == 64
    assert a.chunk_duration == 20.0 and a.frame_threshold == 25
    assert a.prefill_step_size == 1024 and a.batch_size == 4
    assert a.gen_kwargs == {"beam_size": 5}
    assert a.context == "names" and a.prompt == "p"
    assert a.text == "align me" and a.stream

    b = parse_args(["--model", "m", "--audio", "x.wav",
                    "--output_path", "o", "--max_tokens", "64",
                    "--chunk_duration", "20"])
    assert b.output_path == "o" and b.max_tokens == 64
    assert b.chunk_duration == 20.0


def test_generate_transcription_filters_kwargs():
    from mlx_audio_tpu_torch.stt.generate import generate_transcription
    from mlx_audio_tpu_torch.stt.models.base import STTOutput

    seen = {}

    class FakeModel:
        def generate(self, audio, language=None, beam_size=1):
            seen.update(language=language, beam_size=beam_size)
            return STTOutput(text="ok")

    out = generate_transcription(
        "m", "f.wav", model=FakeModel(), verbose=False,
        language="en", chunk_duration=30.0, frame_threshold=25,
        gen_kwargs={"beam_size": 5})
    assert out.text == "ok"
    assert seen == {"language": "en", "beam_size": 5}


def test_streaming_accumulation():
    from mlx_audio_tpu_torch.stt.generate import generate_transcription
    from mlx_audio_tpu_torch.stt.models.base import STTOutput

    class FakeModel:
        def generate(self, audio, stream=False):
            assert stream
            yield STTOutput(text="hello ", segments=[{"id": 0}])
            yield STTOutput(text="world", segments=[{"id": 1}])

    out = generate_transcription("m", "f.wav", model=FakeModel(),
                                 verbose=False, stream=True)
    assert out.text == "hello world"
    assert [s["id"] for s in out.segments] == [0, 1]


@pytest.mark.parametrize("fmt", ["txt", "srt", "vtt", "json"])
def test_transcription_files_match_jax(checkpoint, wav, tmp_path, fmt):
    """The same checkpoint and WAV through both packages' CLI function
    (greedy, as `--temperature 0` by default, with word timestamps)."""
    from mlx_audio_tpu.stt.generate import (
        generate_transcription as jax_generate_transcription)
    from mlx_audio_tpu_torch.stt.generate import generate_transcription
    from mlx_audio_tpu_torch.stt.utils import load_model

    path, jm = checkpoint
    kw = dict(format=fmt, verbose=False, temperature=0.0,
              word_timestamps=True, language="en")
    want = jax_generate_transcription(str(path), str(wav), model=jm,
                                      output_path=str(tmp_path / "jax"), **kw)
    got = generate_transcription(str(path), str(wav),
                                 model=load_model(path, device="cpu"),
                                 output_path=str(tmp_path / "port"), **kw)
    assert got.text == want.text
    g = (tmp_path / "port" / f"transcription.{fmt}").read_text("utf-8")
    w = (tmp_path / "jax" / f"transcription.{fmt}").read_text("utf-8")
    if fmt != "json":
        assert g == w
        return
    g, w = json.loads(g), json.loads(w)
    assert g["text"] == w["text"] and g["language"] == w["language"]
    assert len(g["segments"]) == len(w["segments"]) > 0
    for a, b in zip(g["segments"], w["segments"]):
        assert set(a) == set(b)
        for k in a:
            if k in ("avg_logprob", "no_speech_prob"):
                assert abs(a[k] - b[k]) <= FLOAT_TOL
            elif k == "words":
                assert [x["word"] for x in a[k]] == [x["word"] for x in b[k]]
                assert [(x["start"], x["end"]) for x in a[k]] == \
                    [(x["start"], x["end"]) for x in b[k]]
            else:
                assert a[k] == b[k], k


def test_cli_stream_runs_the_streaming_session(checkpoint, wav, capsys,
                                               monkeypatch):
    """`--stream` on Whisper prints and accumulates the session's deltas
    into its final text (the JAX package's CLI fails here: its Whisper
    returns one result for stream=True)."""
    import mlx_audio_tpu_torch.stt.utils as stt_utils
    from mlx_audio_tpu_torch.stt.generate import main

    path, _ = checkpoint
    real = stt_utils.load_model
    final = list(real(path, device="cpu").generate_streaming(
        str(wav)))[-1].text
    monkeypatch.setattr(stt_utils, "load_model",
                        lambda p: real(p, device="cpu"))
    main(["--model", str(path), "--audio", str(wav), "--stream",
          "--language", "en"])
    printed = capsys.readouterr().out
    assert final and final in printed


# ---------------------------------------------------------------------------
# Voxtral Realtime
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def voxtral_checkpoint(tmp_path_factory):
    """A tiny Voxtral Realtime checkpoint directory and the JAX package's
    model loaded from it."""
    from chip_smoke import write_voxtral_checkpoint
    from mlx_audio_tpu.stt.utils import load_model as jax_load_model
    from test_torch_voxtral_realtime import config_dict, model_pair

    _, pm = model_pair(config_dict())
    path = tmp_path_factory.mktemp("voxtral-tiny")
    write_voxtral_checkpoint(pm, path)
    return path, jax_load_model(path)


def test_load_voxtral_matches_jax(voxtral_checkpoint, wav):
    import mlx_audio_tpu_torch
    from mlx_audio_tpu_torch.stt.models.voxtral_realtime import Model
    from mlx_audio_tpu_torch.stt.utils import load_model

    path, jm = voxtral_checkpoint
    for load in (load_model, mlx_audio_tpu_torch.load_model):
        pm = load(path, device="cpu")
        assert isinstance(pm, Model) and pm.device.type == "cpu"
        assert pm._tokenizer is not None
    got, want = pm.generate(str(wav)), jm.generate(str(wav))
    assert got.text and got.text == want.text
    assert got.generation_tokens == want.generation_tokens
    audio = np.random.RandomState(0).randn(16000 * 2).astype(np.float32)
    np.testing.assert_allclose(pm.encode(audio)[0].numpy(),
                               jm.encode(audio)[0], atol=2e-4, rtol=0)


@pytest.mark.parametrize("fmt", ["txt", "srt", "vtt", "json"])
def test_voxtral_transcription_files_match_jax(voxtral_checkpoint, wav,
                                               tmp_path, fmt):
    from mlx_audio_tpu.stt.generate import (
        generate_transcription as jax_generate_transcription)
    from mlx_audio_tpu_torch.stt.generate import generate_transcription
    from mlx_audio_tpu_torch.stt.utils import load_model

    path, jm = voxtral_checkpoint
    kw = dict(format=fmt, verbose=False, max_tokens=64)
    jax_generate_transcription(str(path), str(wav), model=jm,
                               output_path=str(tmp_path / "jax"), **kw)
    generate_transcription(str(path), str(wav),
                           model=load_model(path, device="cpu"),
                           output_path=str(tmp_path / "port"), **kw)
    g = (tmp_path / "port" / f"transcription.{fmt}").read_text("utf-8")
    assert g == (tmp_path / "jax" / f"transcription.{fmt}").read_text("utf-8")
    assert len(g.strip()) > 0


def test_voxtral_cli_stream_prints_the_deltas(voxtral_checkpoint, wav,
                                              capsys, monkeypatch):
    """`--stream` on Voxtral accumulates the text deltas of
    `generate(stream=True)` (JAX's deltas); the JAX package's CLI fails
    on them (they are strings, not STTOutputs)."""
    import mlx_audio_tpu_torch.stt.utils as stt_utils
    from mlx_audio_tpu.stt.generate import (
        generate_transcription as jax_generate_transcription)
    from mlx_audio_tpu_torch.stt.generate import main

    path, jm = voxtral_checkpoint
    want = "".join(jm.generate(str(wav), stream=True))
    with pytest.raises(AttributeError):
        jax_generate_transcription(str(path), str(wav), model=jm,
                                   verbose=False, stream=True)
    real = stt_utils.load_model
    monkeypatch.setattr(stt_utils, "load_model",
                        lambda p: real(p, device="cpu"))
    main(["--model", str(path), "--audio", str(wav), "--stream"])
    printed = capsys.readouterr().out
    assert want.strip() and want in printed


# ---------------------------------------------------------------------------
# Cohere ASR
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cohere_checkpoint(tmp_path_factory):
    """A tiny Cohere ASR checkpoint directory and the JAX package's model
    loaded from it."""
    from chip_smoke import write_cohere_checkpoint
    from mlx_audio_tpu.stt.utils import load_model as jax_load_model
    from test_torch_cohere_asr import model_pair

    _, pm = model_pair()
    path = tmp_path_factory.mktemp("cohere-tiny")
    write_cohere_checkpoint(pm, path)
    return path, jax_load_model(path)


def test_load_cohere_matches_jax(cohere_checkpoint, wav):
    import mlx_audio_tpu_torch
    from mlx_audio_tpu_torch.stt.models.cohere_asr import Model
    from mlx_audio_tpu_torch.stt.utils import load_model

    path, jm = cohere_checkpoint
    for load in (load_model, mlx_audio_tpu_torch.load_model):
        pm = load(path, device="cpu")
        assert isinstance(pm, Model) and pm.device.type == "cpu"
        assert pm._tokenizer is not None
    got, want = pm.generate(str(wav)), jm.generate(str(wav))
    assert got.text and (got.text, got.segments) == (want.text, want.segments)
    assert got.generation_tokens == want.generation_tokens
    assert len(got.segments) >= 3


@pytest.mark.parametrize("fmt", ["txt", "srt", "vtt", "json"])
def test_cohere_transcription_files_match_jax(cohere_checkpoint, wav,
                                              tmp_path, fmt):
    from mlx_audio_tpu.stt.generate import (
        generate_transcription as jax_generate_transcription)
    from mlx_audio_tpu_torch.stt.generate import generate_transcription
    from mlx_audio_tpu_torch.stt.utils import load_model

    path, jm = cohere_checkpoint
    kw = dict(format=fmt, verbose=False, max_tokens=24)
    jax_generate_transcription(str(path), str(wav), model=jm,
                               output_path=str(tmp_path / "jax"), **kw)
    generate_transcription(str(path), str(wav),
                           model=load_model(path, device="cpu"),
                           output_path=str(tmp_path / "port"), **kw)
    g = (tmp_path / "port" / f"transcription.{fmt}").read_text("utf-8")
    assert g == (tmp_path / "jax" / f"transcription.{fmt}").read_text("utf-8")
    assert len(g.strip()) > 0


def test_cohere_cli_defaults_the_language(cohere_checkpoint, wav, tmp_path,
                                          monkeypatch):
    """The CLI drops the --language it was not given, so generate() takes
    its "en"; the CLI's options that Cohere has no use for land in its
    **kwargs. The json output equals generate() in process."""
    import mlx_audio_tpu_torch.stt.utils as stt_utils
    from mlx_audio_tpu_torch.stt.generate import main

    path, _ = cohere_checkpoint
    real = stt_utils.load_model
    monkeypatch.setattr(stt_utils, "load_model",
                        lambda p: real(p, device="cpu"))
    main(["--model", str(path), "--audio", str(wav), "--format", "json",
          "--output-path", str(tmp_path), "--no-verbose",
          "--max-tokens", "16", "--max-parallel-segments", "1"])
    got = json.loads((tmp_path / "transcription.json").read_text())
    want = real(path, device="cpu").generate(str(wav), max_tokens=16,
                                             batch_size=1)
    assert got["language"] == "en"
    assert (got["text"], got["segments"]) == (
        want.text, json.loads(json.dumps(want.segments)))
