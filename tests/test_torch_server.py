"""The PyTorch port's server (`mlx_audio_tpu_torch/server.py`) on the CPU,
case for case against tests/test_server.py: every endpoint, the studio UI,
the server config, the concurrent-speech TTFA case and the voice library,
with fake models as there; the aiohttp app (`create_app`) over the
server's request core, driven by aiohttp's TestClient. Then what the port
adds: a tiny Kokoro checkpoint on disk served by both packages' servers
(the port's WAV held to the JAX server's), `/v1/realtime` with `server_vad`
over scripted probabilities (the same events as the JAX server's), the
session warm-up error logged, an unported option answered 501,
Qwen3-TTS voice cloning (base64 and the voice library) answered with
generate()'s audio, the tensor-parallel refusal, the CPU device, and a
Parakeet directory's transcription in overlapping windows.

Tolerances: the served Kokoro audio within 1e-4 relative to its largest
value (f32 on both sides, summation order only, as
tests/test_torch_kokoro.py), then written as 16-bit PCM by both servers.
"""

import asyncio
import base64
import io
import json
import logging
import os
from dataclasses import dataclass

import numpy as np
import pytest

pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401
pytest.importorskip("aiohttp")

AUDIO_REL = 1e-4


@dataclass
class _FakeResult:
    audio: np.ndarray
    sample_rate: int = 24000
    is_final_chunk: bool = False


class FakeTTS:
    sample_rate = 24000

    def generate(self, text, **kwargs):
        t = np.linspace(0, 0.2, 4800)
        yield _FakeResult(audio=(0.3 * np.sin(2 * np.pi * 440 * t)).astype(
            np.float32))


class FakeSTT:
    def generate(self, audio, **kwargs):
        from mlx_audio_tpu_torch.stt.models.base import STTOutput

        return STTOutput(text=f"heard {len(audio)} samples", language="en",
                         segments=[{"start": 0.0, "end": 1.0,
                                    "text": "heard"}])


def _make_server():
    from mlx_audio_tpu_torch.server import AudioServer

    server = AudioServer(device="cpu")
    server.provider._models["fake-tts"] = FakeTTS()
    server.provider._models["fake-stt"] = FakeSTT()

    async def _noload(name, category=None):
        m = server.provider._models.get(name)
        if m is None:
            raise FileNotFoundError(name)
        return m

    server.provider.load = _noload
    return server


def _client(server):
    from aiohttp.test_utils import TestClient, TestServer

    from mlx_audio_tpu_torch.server import create_app

    return TestClient(TestServer(create_app(server=server)))


def _run(coro):
    return asyncio.run(coro)


def _wav(audio, sr):
    from mlx_audio_tpu_torch import audio_io

    buf = io.BytesIO()
    audio_io.write(buf, audio, sr)
    return buf.getvalue()


def _read(data):
    from mlx_audio_tpu_torch import audio_io

    return audio_io.read(io.BytesIO(data), dtype="float32")


def _form(**fields):
    import aiohttp

    form = aiohttp.FormData()
    for k, v in fields.items():
        if k == "file":
            form.add_field("file", v, filename="a.wav")
        else:
            form.add_field(k, v)
    return form


class TestEndpoints:
    def test_health_and_models(self):
        async def go():
            server = _make_server()
            async with _client(server) as client:
                r = await client.get("/health")
                assert (await r.json())["status"] == "ok"
                r = await client.get("/v1/models")
                ids = [m["id"] for m in (await r.json())["data"]]
                assert "fake-tts" in ids and "fake-stt" in ids
                r = await client.delete("/v1/models/fake-stt")
                assert r.status == 200
                r = await client.delete("/v1/models/fake-stt")
                assert r.status == 404

        _run(go())

    def test_tts_speech_wav(self):
        async def go():
            server = _make_server()
            async with _client(server) as client:
                r = await client.post("/v1/audio/speech", json={
                    "model": "fake-tts", "input": "hello"})
                assert r.status == 200
                audio, sr = _read(await r.read())
                assert sr == 24000 and len(audio) == 4800
                r = await client.post("/v1/audio/speech", json={
                    "model": "missing-model", "input": "x"})
                assert r.status == 404
                r = await client.post("/v1/audio/speech", json={
                    "model": "fake-tts"})
                assert r.status == 400
                r = await client.post("/v1/audio/speech", json={
                    "model": "fake-tts", "input": "x",
                    "response_format": "mp3"})
                assert r.status == 400

        _run(go())

    def test_stt_transcription_formats(self):
        async def go():
            server = _make_server()
            wav = _wav(np.zeros(16000, np.float32), 16000)
            async with _client(server) as client:
                r = await client.post("/v1/audio/transcriptions", data=_form(
                    file=wav, model="fake-stt"))
                assert r.status == 200
                assert "heard" in (await r.json())["text"]
                r = await client.post("/v1/audio/transcriptions", data=_form(
                    file=wav, model="fake-stt",
                    response_format="verbose_json"))
                data = await r.json()
                assert data["language"] == "en" and data["segments"]
                r = await client.post("/v1/audio/transcriptions", data=_form(
                    file=wav, model="fake-stt", response_format="srt"))
                assert "-->" in (await r.text())
                r = await client.post("/v1/audio/transcriptions", data=_form(
                    file=wav, model="fake-stt", response_format="vtt"))
                assert (await r.text()).startswith("WEBVTT")
                r = await client.post("/v1/audio/transcriptions", data=_form(
                    file=wav, model="fake-stt", response_format="text"))
                assert (await r.text()) == "heard 16000 samples"

        _run(go())

    def test_tts_extended_request_fields(self):
        async def go():
            server = _make_server()
            seen = {}

            class KnobTTS:
                sample_rate = 24000

                def generate(self, text, instruct=None, ref_audio=None,
                             ref_text=None, **kwargs):
                    seen.update(instruct=instruct, ref_text=ref_text,
                                ref_audio_len=None if ref_audio is None
                                else len(ref_audio))
                    yield _FakeResult(audio=np.zeros(100, np.float32))

            server.provider._models["knob-tts"] = KnobTTS()
            b64 = base64.b64encode(_wav(np.zeros(2400, np.float32),
                                        24000)).decode()
            async with _client(server) as client:
                r = await client.post("/v1/audio/speech", json={
                    "model": "knob-tts", "input": "x",
                    "instruct": "whisper softly", "gender": "female",
                    "pitch": 1.2, "ref_audio": b64, "ref_text": "hi"})
                assert r.status == 200
                await r.read()
                r = await client.post("/v1/audio/speech", json={
                    "model": "knob-tts", "input": "x",
                    "ref_audio": "/nonexistent/voice.wav"})
                assert r.status == 404
            assert seen["instruct"] == "whisper softly"
            assert seen["ref_text"] == "hi"
            assert seen["ref_audio_len"] == 2400

        _run(go())

    def test_tts_pcm_streaming_with_sample_rate_header(self):
        async def go():
            server = _make_server()

            class ChunkTTS:
                sample_rate = 22050

                def generate(self, text, stream=False, **kwargs):
                    assert stream
                    for i in range(3):
                        t = np.linspace(0, 0.1, 2205)
                        yield _FakeResult(audio=(0.2 * np.sin(
                            2 * np.pi * (300 + 100 * i) * t)).astype(
                                np.float32), sample_rate=22050)

            server.provider._models["chunk-tts"] = ChunkTTS()
            async with _client(server) as client:
                r = await client.post("/v1/audio/speech", json={
                    "model": "chunk-tts", "input": "stream me",
                    "stream": True, "response_format": "pcm"})
                assert r.status == 200
                assert r.headers["X-Sample-Rate"] == "22050"
                assert r.headers["Content-Type"] == \
                    "application/octet-stream"
                body = await r.read()
                assert len(body) == 3 * 2205 * 2
                pcm = np.frombuffer(body, "<i2").astype(np.float32) / 32768
                assert np.abs(pcm).max() > 0.1
                # streamed wav: one WAV per chunk
                r = await client.post("/v1/audio/speech", json={
                    "model": "chunk-tts", "input": "stream me",
                    "stream": True})
                assert r.headers["Content-Type"] == "audio/wav"
                body = await r.read()
                assert body.count(b"RIFF") == 3

        _run(go())

    def test_stt_ndjson_streaming(self):
        async def go():
            from mlx_audio_tpu_torch.stt.models.base import STTOutput

            server = _make_server()

            class StreamSTT:
                def generate(self, audio, stream=False, **kwargs):
                    assert stream
                    yield STTOutput(text="hello ")
                    yield STTOutput(text="world", language="en")

            server.provider._models["stream-stt"] = StreamSTT()
            wav = _wav(np.zeros(16000, np.float32), 16000)
            async with _client(server) as client:
                r = await client.post("/v1/audio/transcriptions", data=_form(
                    file=wav, model="stream-stt", stream="true",
                    response_format="ndjson"))
                assert r.status == 200
                lines = [json.loads(ln) for ln in
                         (await r.text()).strip().splitlines()]
                assert [ln["text"] for ln in lines] == ["hello ", "world"]
                r = await client.post("/v1/audio/transcriptions", data=_form(
                    file=wav, model="stream-stt", stream="true",
                    response_format="text"))
                assert (await r.text()).strip() == "hello world"

        _run(go())

    def test_stt_extended_fields_filtered(self):
        async def go():
            from mlx_audio_tpu_torch.stt.models.base import STTOutput

            server = _make_server()
            seen = {}

            class KnobSTT:
                def generate(self, audio, language=None,
                             chunk_duration=30.0, context=None):
                    seen.update(language=language,
                                chunk_duration=chunk_duration,
                                context=context)
                    return STTOutput(text="ok")

            server.provider._models["knob-stt"] = KnobSTT()
            wav = _wav(np.zeros(16000, np.float32), 16000)
            async with _client(server) as client:
                r = await client.post("/v1/audio/transcriptions", data=_form(
                    file=wav, model="knob-stt", language="de",
                    chunk_duration="20.5", context="hotwords here",
                    frame_threshold="25", max_tokens="64"))
                assert r.status == 200
            assert seen == {"language": "de", "chunk_duration": 20.5,
                            "context": "hotwords here"}

        _run(go())

    def test_separations_endpoint(self):
        async def go():
            class _Res:
                def __init__(self, vocals, sr):
                    self.vocals = vocals
                    self.sample_rate = sr

            class _Cfg:
                sample_rate = 16000

            class FakeSeparator:
                config = _Cfg()

                def separate(self, audio):
                    return _Res(np.asarray(audio) * 0.5, 16000)

            server = _make_server()
            server.provider._models["fake-sep"] = FakeSeparator()
            wav = _wav(np.ones(8000, np.float32) * 0.2, 16000)
            async with _client(server) as client:
                r = await client.post("/v1/audio/separations", data=_form(
                    file=wav, model="fake-sep"))
                assert r.status == 200
                data = await r.json()
                assert data["sample_rate"] == 16000
                tgt, _ = _read(base64.b64decode(data["target"]))
                res, _ = _read(base64.b64decode(data["residual"]))
                assert abs(float(np.abs(tgt).mean()) - 0.1) < 0.01
                assert abs(float(np.abs(res).mean()) - 0.1) < 0.01
                r = await client.post("/v1/audio/separations",
                                      data=_form(model="fake-sep"))
                assert r.status == 400
                r = await client.post("/v1/audio/separations", data=_form(
                    file=wav, model="nope"))
                assert r.status == 404

        _run(go())

    def test_realtime_ws_manual_commit(self):
        async def go():
            server = _make_server()
            async with _client(server) as client:
                ws = await client.ws_connect("/v1/realtime?model=fake-stt")
                created = json.loads((await ws.receive()).data)
                assert created["type"] == "session.created"
                await ws.send_json({"type": "session.update", "session": {
                    "turn_detection": None}})
                updated = json.loads((await ws.receive()).data)
                assert updated["type"] == "session.updated"
                pcm = np.zeros(8000).astype("<i2").tobytes()
                await ws.send_json({
                    "type": "input_audio_buffer.append",
                    "audio": base64.b64encode(pcm).decode()})
                await ws.send_json({"type": "input_audio_buffer.commit"})
                msg = json.loads((await ws.receive()).data)
                assert msg["type"] == "input_audio_buffer.committed"
                msg = json.loads((await ws.receive()).data)
                assert msg["type"] == "conversation.item.added"
                assert msg["item"]["role"] == "user"
                msg = json.loads((await ws.receive()).data)
                assert msg["type"].endswith("transcription.completed")
                assert "heard" in msg["transcript"]
                await ws.send_json({"type": "session.close"})
                await ws.close()

        _run(go())

    def test_transcriptions_ws(self):
        async def go():
            server = _make_server()
            async with _client(server) as client:
                ws = await client.ws_connect(
                    "/v1/audio/transcriptions/realtime?model=fake-stt")
                await ws.send_bytes(np.zeros(4000, dtype="<i2").tobytes())
                await ws.send_json({"type": "commit"})
                msg = json.loads((await ws.receive()).data)
                assert msg == {"type": "transcription",
                               "text": "heard 4000 samples"}
                await ws.send_json({"type": "close"})
                await ws.close()

        _run(go())


class TestStudioUI:
    def test_index_and_assets(self):
        async def go():
            server = _make_server()
            async with _client(server) as client:
                r = await client.get("/")
                assert r.status == 200
                assert "MLX Audio TPU Studio" in await r.text()
                for asset, marker in (("style.css", "--accent"),
                                      ("app.js", "/v1/audio/speech")):
                    r = await client.get(f"/ui/{asset}")
                    assert r.status == 200
                    assert marker in await r.text()

        _run(go())

    def test_traversal_blocked(self):
        async def go():
            server = _make_server()
            async with _client(server) as client:
                r = await client.get("/ui/%2e%2e/%2e%2e/server.py")
                assert r.status == 404
                r = await client.get("/ui/nope.js")
                assert r.status == 404

        _run(go())


class TestServerConfig:
    def test_cli_env_bridge(self, monkeypatch):
        from mlx_audio_tpu_torch.server import _bridge_cli_env, parse_args

        for var in ("MLX_AUDIO_ALLOWED_ORIGINS", "MLX_AUDIO_REALTIME_MODEL",
                    "MLX_AUDIO_REALTIME_TRANSCRIPTION_DELAY_MS",
                    "MLX_AUDIO_VAD_MODEL", "MLX_AUDIO_TTS_MAX_BATCH_SIZE"):
            monkeypatch.delenv(var, raising=False)
        args = parse_args([
            "--allowed-origins", "https://a.com", "https://b.com",
            "--realtime-model", "voxtral-rt",
            "--realtime-transcription-delay-ms", "240",
            "--vad-model", "silero", "--tts-max-batch-size", "8"])
        assert args.device == "cuda"
        _bridge_cli_env(args)
        assert os.environ["MLX_AUDIO_ALLOWED_ORIGINS"] == \
            "https://a.com,https://b.com"
        assert os.environ["MLX_AUDIO_REALTIME_MODEL"] == "voxtral-rt"
        assert os.environ[
            "MLX_AUDIO_REALTIME_TRANSCRIPTION_DELAY_MS"] == "240"
        assert os.environ["MLX_AUDIO_VAD_MODEL"] == "silero"
        assert os.environ["MLX_AUDIO_TTS_MAX_BATCH_SIZE"] == "8"

    def test_realtime_delay_forwarded_to_session(self, monkeypatch):
        """The delay reaches create_streaming_session, on every turn's
        session."""
        async def go():
            server = _make_server()
            seen = []

            class Session:
                input_sample_rate = 16000
                text = "x"
                done = True

                def feed(self, *a):
                    pass

                def step(self):
                    return []

                def close(self):
                    pass

            class RTModel:
                def generate(self, audio, **kw):
                    from mlx_audio_tpu_torch.stt.models.base import STTOutput

                    return STTOutput(text="x")

                def create_streaming_session(self, **kwargs):
                    seen.append(kwargs)
                    return Session()

            server.provider._models["rt"] = RTModel()
            monkeypatch.setenv(
                "MLX_AUDIO_REALTIME_TRANSCRIPTION_DELAY_MS", "240")
            async with _client(server) as client:
                ws = await client.ws_connect("/v1/realtime?model=rt")
                msg = await ws.receive_json()
                assert msg["type"] == "session.created"
                await ws.send_json({"type": "input_audio_buffer.commit"})
                for _ in range(3):
                    await ws.receive_json()
                await ws.close()
            assert seen == [{"transcription_delay_ms": 240}] * 2

        _run(go())

    def test_cors_headers(self, monkeypatch):
        async def go():
            server = _make_server()
            async with _client(server) as client:
                r = await client.get(
                    "/health", headers={"Origin": "http://studio.local"})
                assert r.headers.get("Access-Control-Allow-Origin") == \
                    "http://studio.local"
                r2 = await client.get(
                    "/health", headers={"Origin": "http://evil.example"})
                assert "Access-Control-Allow-Origin" not in r2.headers
                r3 = await client.options(
                    "/v1/audio/speech",
                    headers={"Origin": "http://studio.local"})
                assert r3.status == 204

        monkeypatch.setenv("MLX_AUDIO_ALLOWED_ORIGINS", "http://studio.local")
        _run(go())

    def test_tensor_parallel_refused(self, monkeypatch):
        """The JAX server shards over N devices; the port refuses N > 1,
        naming the ROADMAP item, rather than serve on one device."""
        from mlx_audio_tpu_torch.server import AudioServer, ModelProvider

        with pytest.raises(ValueError, match="queue 1, item 9"):
            AudioServer(tensor_parallel=2, device="cpu")
        monkeypatch.setenv("MLX_AUDIO_TPU_TENSOR_PARALLEL", "4")
        with pytest.raises(ValueError, match="queue 1, item 9"):
            ModelProvider(device="cpu")
        monkeypatch.setenv("MLX_AUDIO_TPU_TENSOR_PARALLEL", "1")
        assert ModelProvider(device="cpu").device.type == "cpu"

    def test_unload_via_body(self):
        async def go():
            server = _make_server()
            async with _client(server) as client:
                r = await client.delete("/v1/models",
                                        json={"model": "fake-tts"})
                assert r.status == 200
                assert (await r.json())["deleted"] is True
                r2 = await client.delete("/v1/models?model=fake-tts")
                assert r2.status == 404
                r3 = await client.delete("/v1/models")
                assert r3.status == 400

        _run(go())

    def test_server_defaults_to_cuda_and_raises_without_it(self, monkeypatch):
        import torch

        from mlx_audio_tpu_torch.server import AudioServer, main

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            AudioServer()
        with pytest.raises(RuntimeError, match='device="cpu"'):
            main(["--port", "0"])


class TestServerLoadTTFA:
    """8 concurrent streamed speech requests against a continuous-batching
    model: all join the broker's session and the p50 time to first audio
    stays under 0.5 s (tests/test_server.py::TestServerLoadTTFA)."""

    def test_concurrent_speech_p50_ttfa(self, monkeypatch):
        async def go():
            import time as _t

            server = _make_server()

            class PacedSession:
                def __init__(self, opts):
                    self.opts = opts
                    self.reqs = {}
                    self.emitted = {}

                @property
                def idle(self):
                    return not self.reqs

                @property
                def available_slots(self):
                    return self.opts.max_batch_size - len(self.reqs)

                def submit(self, request):
                    self.reqs[request.request_id] = request
                    self.emitted[request.request_id] = 0

                def cancel(self, request_id):
                    self.reqs.pop(request_id, None)

                def fail(self, error):
                    for r in self.reqs.values():
                        r.emit_error(error)
                        r.emit_done()
                    self.reqs.clear()

                def step(self):
                    _t.sleep(0.02)
                    done = []
                    for rid, r in self.reqs.items():
                        r.emit_data({"audio": np.zeros(4800, np.float32),
                                     "sample_rate": 24000,
                                     "is_final": False})
                        self.emitted[rid] += 1
                        if self.emitted[rid] >= 5:
                            r.emit_done()
                            done.append(rid)
                    for rid in done:
                        self.reqs.pop(rid)
                    return []

            class ContTTS:
                sample_rate = 24000

                def supports_tts_continuous_batch(self, **kwargs):
                    return True

                def create_tts_batch_session(self, opts):
                    return PacedSession(opts)

                def generate(self, text, **kwargs):
                    yield _FakeResult(audio=np.zeros(4800, np.float32))

            server.provider._models["cont-tts"] = ContTTS()
            async with _client(server) as client:
                async def one():
                    t0 = _t.perf_counter()
                    r = await client.post("/v1/audio/speech", json={
                        "model": "cont-tts", "input": "load test",
                        "stream": True, "response_format": "pcm"})
                    assert r.status == 200
                    ttfa, total = None, 0
                    async for chunk in r.content.iter_chunked(4096):
                        if ttfa is None and chunk:
                            ttfa = _t.perf_counter() - t0
                        total += len(chunk)
                    return ttfa, total

                results = await asyncio.gather(*[one() for _ in range(8)])
            ttfas = sorted(t for t, _ in results)
            assert all(total >= 5 * 4800 * 2 for _, total in results), results
            p50 = ttfas[len(ttfas) // 2]
            assert p50 < 0.5, f"p50 TTFA {p50:.3f}s (all: {ttfas})"

        monkeypatch.setenv("MLX_AUDIO_TTS_MAX_BATCH_SIZE", "8")
        _run(go())


# ---------------------------------------------------------------------------
# Real checkpoints, no fake models
# ---------------------------------------------------------------------------


def write_kokoro_checkpoint(path):
    """A tiny Kokoro checkpoint in the published torch layout (weight-norm
    pairs, LSTM suffixes, (1, C, 1) alphas, LayerNorm gamma/beta) that both
    packages' loaders read, plus a voices/af_heart.safetensors pack."""
    import dataclasses

    from safetensors.numpy import save_file

    from mlx_audio_tpu.tts.models.kokoro import Model
    from mlx_audio_tpu.utils import flatten
    from tiny_configs import tiny_kokoro_config

    jm = Model(tiny_kokoro_config()).init_and_bind()
    fake = {}
    for k, v in flatten(jm.params).items():
        v = np.asarray(v)
        if ".forward." in k or ".backward." in k:
            base, direction, name = k.rsplit(".", 2)
            suffix = name + "_l0" + ("_reverse" if direction == "backward"
                                     else "")
            fake[f"{base}.{suffix}"] = v
        elif k.endswith(".weight") and v.ndim == 3:
            if ".pool." in k:
                torch_w = np.transpose(np.flip(v, 0), (2, 1, 0))
            elif "generator.ups" in k:
                torch_w = np.transpose(np.flip(v, 0), (1, 2, 0))
            else:
                torch_w = np.transpose(v, (2, 1, 0))
            if "noise_convs" in k or "F0_proj" in k or "N_proj" in k:
                fake[k] = np.ascontiguousarray(torch_w)
            else:
                base = k[: -len(".weight")]
                norm = np.sqrt((torch_w ** 2).sum(axis=(1, 2), keepdims=True))
                fake[base + ".weight_v"] = np.ascontiguousarray(torch_w)
                fake[base + ".weight_g"] = norm
        elif ("alpha1" in k or "alpha2" in k) and v.ndim == 1:
            fake[k] = v.reshape(1, -1, 1)
        elif k.endswith("LayerNorm.weight"):
            fake[k[: -len(".weight")] + ".gamma"] = v
        elif k.endswith("LayerNorm.bias"):
            fake[k[: -len(".bias")] + ".beta"] = v
        else:
            fake[k] = v
    cfg = dataclasses.asdict(tiny_kokoro_config())
    cfg["model_type"] = "kokoro"
    (path / "config.json").write_text(json.dumps(cfg))
    save_file(fake, str(path / "model.safetensors"))
    (path / "voices").mkdir()
    pack = (np.random.RandomState(0).randn(510, 1, 32) * 0.1).astype(
        np.float32)
    save_file({"af_heart": pack}, str(path / "voices" / "af_heart.safetensors"))


@pytest.fixture(scope="module")
def kokoro_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("kokoro_ckpt")
    write_kokoro_checkpoint(d)
    return str(d)


class TestRealCheckpointE2E:
    def test_speech_from_disk_checkpoint_matches_jax_server(self, kokoro_dir,
                                                            monkeypatch):
        """The same request to both packages' servers, each loading the
        checkpoint through its own loader: the port's WAV decodes to the
        JAX server's audio (noise off in both, their random streams
        differ)."""
        from mlx_audio_tpu.tts.models.kokoro import Model as JaxKokoro
        from mlx_audio_tpu_torch.tts.models.kokoro import Model as Kokoro

        for cls in (JaxKokoro, Kokoro):
            call = cls.__call__
            monkeypatch.setattr(
                cls, "__call__",
                lambda self, *a, _c=call, **k: _c(
                    self, *a, **{**k, "deterministic_noise": True}))
        request = {"model": kokoro_dir, "input": "end to end test",
                   "voice": "af_heart", "response_format": "wav"}

        async def go():
            from aiohttp.test_utils import TestClient, TestServer

            from mlx_audio_tpu.server import AudioServer as JaxServer
            from mlx_audio_tpu_torch.server import AudioServer, create_app

            bodies = []
            jax_server = JaxServer()
            for app in (jax_server.app,
                        create_app(server=AudioServer(device="cpu"))):
                async with TestClient(TestServer(app)) as client:
                    r = await client.post("/v1/audio/speech", json=request)
                    assert r.status == 200, await r.text()
                    bodies.append(await r.read())
            jax_server.broker.stop_and_join()
            return bodies

        want, got = _run(go())
        assert got[:44] == want[:44]        # the same WAV header
        (a, sr), (b, _) = _read(got), _read(want)
        assert sr == 24000 and len(a) == len(b) > 1000
        assert np.isfinite(a).all()
        assert np.abs(a - b).max() <= AUDIO_REL * np.abs(b).max() + 2 / 32768

    def test_router_loads_the_checkpoint_by_directory(self, kokoro_dir):
        """Load by directory with no category (POST /v1/models), then list
        its voices."""
        async def go():
            from mlx_audio_tpu_torch.server import AudioServer

            server = AudioServer(device="cpu")
            async with _client(server) as client:
                r = await client.post("/v1/models",
                                      json={"model": kokoro_dir})
                assert r.status == 200
                r = await client.get("/v1/audio/voices")
                assert (await r.json())["voices"] == {
                    kokoro_dir: ["af_heart"]}
                r = await client.post("/v1/models",
                                      json={"model": kokoro_dir + "-missing"})
                assert r.status == 404
                assert "never downloads" in (await r.json())["error"]
            assert type(server.provider.get_cached(kokoro_dir)).__module__ \
                .startswith("mlx_audio_tpu_torch.tts.models.kokoro")

        _run(go())


class TestPortServing:
    """What the port's server adds to the JAX server's cases."""

    def test_realtime_server_vad_events_match_jax(self, monkeypatch):
        """/v1/realtime with server_vad, a scripted VAD and a streaming STT
        session: both servers send the same events for the same audio
        (speech_started, the pre-roll flushed into the session, deltas,
        speech_stopped, the committed turn)."""
        from test_vad import _FakeVad

        probs = [0.1] * 4 + [0.9] * 8 + [0.0] * 20

        class Ev:
            def __init__(self, kind, text):
                self.kind, self.text = kind, text

        class Session:
            def __init__(self):
                self.fed = 0
                self.closed = False

            @property
            def text(self):
                return f"fed {self.fed}"

            @property
            def done(self):
                return self.closed

            def feed(self, pcm):
                self.fed += len(pcm)

            def step(self):
                return [Ev("delta", f"+{self.fed}")] + (
                    [Ev("final", f"final {self.fed}")] if self.closed
                    else [])

            def close(self):
                self.closed = True

        class RTModel:
            def create_streaming_session(self):
                return Session()

        audio = (np.random.RandomState(0).randn(512 * len(probs)) * 3000
                 ).astype("<i2")
        monkeypatch.setenv("MLX_AUDIO_VAD_MODEL", "vad")

        async def drive(server, app):
            from aiohttp.test_utils import TestClient, TestServer

            server.provider._models["rt"] = RTModel()
            server.provider._models["vad"] = _FakeVad(probs)

            async def _noload(name, category=None):
                return server.provider._models[name]

            server.provider.load = _noload
            events = []
            async with TestClient(TestServer(app)) as client:
                ws = await client.ws_connect("/v1/realtime?model=rt")
                events.append(await ws.receive_json())
                for off in range(0, len(audio), 1600):
                    await ws.send_json({
                        "type": "input_audio_buffer.append",
                        "audio": base64.b64encode(
                            audio[off:off + 1600].tobytes()).decode()})
                await ws.send_json({"type": "input_audio_buffer.clear"})
                while True:
                    events.append(await ws.receive_json())
                    if events[-1]["type"] == "input_audio_buffer.cleared":
                        break
                await ws.close()
            return events

        async def go():
            from mlx_audio_tpu.server import AudioServer as JaxServer
            from mlx_audio_tpu_torch.server import AudioServer, create_app

            jax_server = JaxServer()
            want = await drive(jax_server, jax_server.app)
            jax_server.broker.stop_and_join()
            server = AudioServer(device="cpu")
            got = await drive(server, create_app(server=server))
            return want, got

        want, got = _run(go())
        for ev in want + got:
            ev.get("session", {}).pop("id", None)
        assert got == want
        kinds = [e["type"] for e in got]
        assert kinds.index("input_audio_buffer.speech_started") < \
            kinds.index("input_audio_buffer.speech_stopped")
        assert any(k.endswith("transcription.completed") for k in kinds)

    def test_session_warmup_error_is_logged(self, caplog):
        """A session whose warm-up raises still serves, and the error is
        logged with its traceback (the JAX server swallows it)."""
        from mlx_audio_tpu_torch.server import TTSExecutionAdapter
        from mlx_audio_tpu_torch.server_inference import InferenceRequest

        class Sess:
            def warmup(self):
                raise RuntimeError("warm-up broke")

        class Model:
            def create_tts_batch_session(self, opts):
                return Sess()

        server = _make_server()
        server.provider._models["m"] = Model()
        adapter = TTSExecutionAdapter(server.provider)
        with caplog.at_level(logging.ERROR, "mlx_audio_tpu_torch.server"):
            sess = adapter.create_continuous_batch_session(InferenceRequest(
                endpoint_kind="tts", model_name="m", payload="x"))
        server.close()
        assert isinstance(sess, Sess)
        (rec,) = caplog.records
        assert "warm-up failed" in rec.getMessage() and rec.exc_info

    def test_unported_option_answers_501(self):
        """An option a model refuses with NotImplementedError (here a model
        whose generate() says an option is not ported yet, as the port's
        Qwen3-TTS does for multi-row text_ids) answers 501 with the model's
        message. (Until Qwen3-TTS voice cloning was ported, this test sent
        it a ref_audio request.)"""
        async def go():
            class Unported(FakeTTS):
                def generate(self, text, instruct=None, **kwargs):
                    if instruct:
                        raise NotImplementedError(
                            "instruct prompts are not ported yet")
                    yield from FakeTTS.generate(self, text)

            server = _make_server()
            server.provider._models["fake-tts"] = Unported()
            async with _client(server) as client:
                r = await client.post("/v1/audio/speech", json={
                    "model": "fake-tts", "input": "x", "instruct": "warm"})
                assert r.status == 501
                assert "not ported yet" in (await r.json())["error"]
                r = await client.post("/v1/audio/speech", json={
                    "model": "fake-tts", "input": "x"})
                assert r.status == 200

        _run(go())

    def test_qwen3_voice_cloning_answers_200(self, tmp_path):
        """Qwen3-TTS with ref_audio (base64 with ref_text, then
        "voice:<name>" with the ref_text the library stored): 200 with the
        PCM of the model's own generate() for the same request and seed,
        through the serial path (no continuous-batching session)."""
        from chip_smoke import _qwen3_clone_small
        from mlx_audio_tpu_torch.voice_store import VoiceStore

        model = _qwen3_clone_small("cpu")
        ref = (np.random.RandomState(5).randn(2400) * 0.3).astype(np.float32)
        wav = _wav(ref, 24000)
        knobs = {"max_tokens": 6, "temperature": 0.9, "seed": 3,
                 "response_format": "pcm"}

        async def go():
            server = _make_server()
            server.voices = VoiceStore(tmp_path)
            server.voices.save("narrator", ref, 24000,
                               ref_text="reference words")
            server.provider._models["q3"] = model
            bodies = []
            async with _client(server) as client:
                for ref_audio, extra in (
                        (base64.b64encode(wav).decode(),
                         {"ref_text": "reference words"}),
                        ("voice:narrator", {})):
                    r = await client.post("/v1/audio/speech", json={
                        "model": "q3", "input": "hello there",
                        "ref_audio": ref_audio, **knobs, **extra})
                    assert r.status == 200, await r.text()
                    bodies.append(await r.read())
                assert not server.broker._sessions
            return bodies, server.voices.load("narrator", sample_rate=24000)

        (b64_body, voice_body), stored = _run(go())
        for body, clip in ((b64_body, _read(wav)[0]), (voice_body, stored)):
            (want,) = model.generate("hello there", ref_audio=clip,
                                     ref_text="reference words",
                                     max_tokens=6, temperature=0.9, seed=3)
            assert model.last_run["ref_frames"] > 0
            pcm = np.frombuffer(body, "<i2").astype(int)
            ref_pcm = np.clip(np.round(want.audio * 32768.0), -32768,
                              32767).astype(int)
            assert len(pcm) == len(ref_pcm) == 6 * model.total_upsample
            assert np.abs(pcm - ref_pcm).max() <= 1

    def test_qwen3_speech_through_the_session(self):
        """A text request to a Qwen3-TTS model with a tokenizer runs in the
        broker's continuous-batching session and returns its audio."""
        async def go():
            from test_qwen3_tts_icl import FakeTokenizer
            from test_torch_qwen3_tts import _port

            server = _make_server()
            model = _port("tiny")
            model.tokenizer = FakeTokenizer()
            server.provider._models["q3"] = model
            async with _client(server) as client:
                r = await client.post("/v1/audio/speech", json={
                    "model": "q3", "input": "hello there", "max_tokens": 6,
                    "temperature": 0.9, "response_format": "pcm"})
                assert r.status == 200
                body = await r.read()
                assert [key[1] for key in server.broker._sessions] == ["q3"]
            assert len(body) % (2 * model.total_upsample) == 0 and body

        _run(go())

    def test_core_answers_without_aiohttp(self):
        """The request core on its own: the same speech and transcription
        code that the routes wrap, called directly."""
        async def go():
            server = _make_server()
            reply = await server.speech({"model": "fake-tts",
                                         "input": "hello"})
            audio, sr = _read(await reply.read())
            reply = await server.transcribe(
                {"model": "fake-stt", "response_format": "ndjson"},
                _wav(np.zeros(800, np.float32), 16000))
            lines = (await reply.read()).decode().splitlines()
            server.close()
            return audio, sr, lines

        audio, sr, lines = _run(go())
        assert sr == 24000 and len(audio) == 4800
        assert json.loads(lines[0])["text"] == "heard 800 samples"


# ---------------------------------------------------------------------------
# Voice library
# ---------------------------------------------------------------------------


class TestVoiceLibrary:
    def test_store_crud(self, tmp_path):
        from mlx_audio_tpu_torch.voice_store import VoiceStore, VoiceStoreError

        store = VoiceStore(tmp_path)
        assert store.list() == []
        wav = (0.1 * np.sin(np.linspace(0, 40, 24000))).astype(np.float32)
        meta = store.save("Narrator A", wav, 24000, ref_text="hello there")
        assert meta["duration_s"] == 1.0 and meta["ref_text"] == "hello there"
        assert [v["name"] for v in store.list()] == ["Narrator A"]
        got = store.load("Narrator A")
        np.testing.assert_allclose(got, wav, atol=2e-4)
        up = store.load("Narrator A", sample_rate=48000)
        assert abs(len(up) - 48000) <= 4
        assert store.resolve_ref("voice:Narrator A") == "Narrator A"
        assert store.resolve_ref("/some/path.wav") is None
        with pytest.raises(VoiceStoreError):
            store.save("../evil", wav, 24000)
        with pytest.raises(VoiceStoreError):
            store.load("nope")
        with pytest.raises(VoiceStoreError):
            store.save("too short", wav[:100], 24000)
        assert store.delete("Narrator A") and not store.delete("Narrator A")
        assert store.list() == []

    def test_store_files_match_jax_store(self, tmp_path):
        """The port's store writes the JAX store's WAV bytes and metadata
        keys, and each reads the other's voice back."""
        from mlx_audio_tpu.voice_store import VoiceStore as JaxStore
        from mlx_audio_tpu_torch.voice_store import VoiceStore

        wav = (0.1 * np.sin(np.linspace(0, 40, 16000))).astype(np.float32)
        JaxStore(tmp_path / "j").save("v", wav, 16000, ref_text="t")
        VoiceStore(tmp_path / "p").save("v", wav, 16000, ref_text="t")
        assert (tmp_path / "j" / "v.wav").read_bytes() == \
            (tmp_path / "p" / "v.wav").read_bytes()
        mj, mp = (json.loads((tmp_path / d / "v.json").read_text())
                  for d in ("j", "p"))
        assert mj.keys() == mp.keys() and mj["duration_s"] == mp["duration_s"]
        np.testing.assert_array_equal(
            VoiceStore(tmp_path / "j").load("v", sample_rate=24000),
            np.asarray(JaxStore(tmp_path / "p").load("v", sample_rate=24000)))

    def test_save_clone_replay_endpoints(self, tmp_path):
        async def go():
            from mlx_audio_tpu_torch.voice_store import VoiceStore

            server = _make_server()
            server.voices = VoiceStore(tmp_path)
            seen = {}

            class CloningTTS(FakeTTS):
                def generate(self, text, ref_audio=None, ref_text=None,
                             **kw):
                    seen["ref_audio"] = ref_audio
                    seen["ref_text"] = ref_text
                    yield from FakeTTS.generate(self, text)

            server.provider._models["fake-tts"] = CloningTTS()
            ref = (0.2 * np.sin(np.linspace(0, 60, 16000))).astype(
                np.float32)
            b64 = base64.b64encode(_wav(ref, 16000)).decode()
            async with _client(server) as client:
                r = await client.post("/v1/audio/voices", json={
                    "name": "my-voice", "audio": b64,
                    "ref_text": "reference words"})
                assert r.status == 201
                assert (await r.json())["name"] == "my-voice"
                r = await client.get("/v1/audio/voices")
                names = [v["name"] for v in (await r.json())["custom"]]
                assert names == ["my-voice"]
                r = await client.get("/v1/audio/voices/my-voice")
                assert r.status == 200
                wav, sr = _read(await r.read())
                assert sr == 16000 and len(wav) == 16000
                r = await client.post("/v1/audio/speech", json={
                    "model": "fake-tts", "input": "clone me",
                    "ref_audio": "voice:my-voice"})
                assert r.status == 200
                assert seen["ref_text"] == "reference words"
                assert abs(len(seen["ref_audio"]) - 24000) <= 6
                r = await client.post("/v1/audio/speech", json={
                    "model": "fake-tts", "input": "x",
                    "ref_audio": "voice:ghost"})
                assert r.status == 404
                r = await client.post("/v1/audio/voices", json={"name": "x"})
                assert r.status == 400
                r = await client.post("/v1/audio/voices", json={
                    "name": "x", "audio": "!!!notb64"})
                assert r.status == 400
                r = await client.delete("/v1/audio/voices/my-voice")
                assert r.status == 200
                r = await client.delete("/v1/audio/voices/my-voice")
                assert r.status == 404

        _run(go())


def test_parakeet_transcription_by_directory(tmp_path):
    """A tiny Parakeet directory (CTC decoding, which keeps this cheap on
    the CPU) served by path through the transcription route, as
    verbose_json with chunk_duration 16 (a 17.5-s WAV, the default 15-s
    overlap: three windows): the text and segments of the directory's
    model's own generate()."""
    from chip_smoke import _parakeet_small, write_parakeet_checkpoint
    from mlx_audio_tpu_torch.server import AudioServer
    from mlx_audio_tpu_torch.stt.utils import load_model

    ckpt = tmp_path / "parakeet-ctc-tiny"
    write_parakeet_checkpoint(_parakeet_small("ctc", "cpu"), ckpt)
    wav = _wav((np.random.RandomState(12).randn(280000) * 0.1)
               .astype(np.float32), 16000)

    async def go():
        server = AudioServer(device="cpu")
        try:
            return await server.transcribe(
                {"model": str(ckpt), "response_format": "verbose_json",
                 "chunk_duration": "16"}, wav)
        finally:
            server.close()

    reply = _run(go())
    model = load_model(ckpt, device="cpu")
    want = model.generate(_read(wav)[0], chunk_duration=16)
    assert model.last_run["windows"] == 3
    assert reply.status == 200, reply.json
    assert reply.json["language"] == "en" and want.segments
    assert (reply.json["text"], reply.json["segments"]) == (
        want.text, json.loads(json.dumps(want.segments)))


def test_qwen3_asr_and_aligner_transcriptions_by_directory(tmp_path,
                                                          monkeypatch):
    """A tiny Qwen3-ASR directory and a tiny forced-aligner directory
    served by path through the transcription route (their tokenizer the
    stand-in one): the text and segments of the directory's model's own
    generate(), and the aligner's words and times for the form's `text`."""
    from mlx_audio_tpu_torch.server import AudioServer
    from mlx_audio_tpu_torch.stt.models.qwen3_asr import qwen3_asr
    from mlx_audio_tpu_torch.stt.utils import load_model
    from test_torch_forced_aligner import FakeTok as AlignTok
    from test_torch_forced_aligner import TEXT
    from test_torch_forced_aligner import pair as aligner_pair
    from chip_smoke import write_asr_checkpoint
    from test_torch_qwen3_asr import CFG, FakeTok, make_pair

    asr, aligner = tmp_path / "qwen3-asr-tiny", tmp_path / "aligner-tiny"
    write_asr_checkpoint(make_pair(CFG)[1], asr)
    write_asr_checkpoint(aligner_pair.__wrapped__()[1], aligner)
    toks = {str(asr): FakeTok(), str(aligner): AlignTok()}
    monkeypatch.setattr(qwen3_asr, "local_tokenizer",
                        lambda path: toks[str(path)])
    audio = (np.random.RandomState(13).randn(24000) * 0.1).astype(np.float32)
    wav = _wav(audio, 16000)

    async def go():
        server = AudioServer(device="cpu")
        try:
            a = await server.transcribe(
                {"model": str(asr), "response_format": "verbose_json",
                 "language": "English", "max_tokens": "24"}, wav)
            b = await server.transcribe(
                {"model": str(aligner), "response_format": "verbose_json",
                 "text": TEXT, "language": "English"}, wav)
            return a, b
        finally:
            server.close()

    a, b = _run(go())
    assert a.status == 200 and b.status == 200, (a.json, b.json)
    heard = _read(wav)[0]
    want = load_model(asr, device="cpu").generate(
        heard, language="English", max_tokens=24)
    assert (a.json["text"], a.json["segments"], a.json["language"]) == (
        want.text, json.loads(json.dumps(want.segments)), want.language)
    al = load_model(aligner, device="cpu").generate(
        heard, text=TEXT, language="English")
    assert (b.json["text"], b.json["segments"], b.json["language"]) == (
        al.text, al.segments, "English")


@pytest.mark.parametrize("family", ["qwen2_audio", "granite_speech",
                                    "vibevoice_asr"])
def test_llm_stt_transcription_by_directory(tmp_path, monkeypatch, family):
    """A tiny Qwen2-Audio, Granite Speech and VibeVoice-ASR directory
    served by path through the transcription route (their tokenizer the
    JAX tests' stand-in): the text of the directory's model's own
    generate()."""
    import importlib

    from chip_smoke import write_llm_stt_checkpoint
    from mlx_audio_tpu_torch.server import AudioServer
    from mlx_audio_tpu_torch.stt.utils import load_model

    tests = importlib.import_module(f"test_torch_{family}")
    make_tok = getattr(tests, "tok2" if family == "granite_speech"
                       else "fake_tok")

    def tokenizer(path, **kw):
        tok = make_tok()
        if family == "vibevoice_asr":     # the ids its hook reads
            tok.convert_tokens_to_ids = {
                "<|object_ref_start|>": 151646, "<|object_ref_end|>": 151647,
                "<|box_start|>": 151648}.get
        return tok

    module = importlib.import_module(
        f"mlx_audio_tpu_torch.stt.models.{family}.{family}")
    monkeypatch.setattr(module, "local_tokenizer", tokenizer)
    d = tmp_path / f"{family}-tiny"
    write_llm_stt_checkpoint(tests.make_pair(tok=False)[1], d)
    audio = (np.random.RandomState(16).randn(8000) * 0.1).astype(np.float32)
    wav = _wav(audio, 16000)

    async def go():
        server = AudioServer(device="cpu")
        try:
            return await server.transcribe(
                {"model": str(d), "response_format": "json",
                 "max_tokens": "16"}, wav)
        finally:
            server.close()

    reply = _run(go())
    assert reply.status == 200, reply.json
    heard = _read(wav)[0]
    model = load_model(d, device="cpu")
    want = model.generate(heard, max_tokens=16)
    assert want.generation_tokens > 0
    assert reply.json["text"] == want.text


@pytest.mark.parametrize("family", ["lasr_ctc", "moonshine",
                                    "moss_transcribe_diarize",
                                    "higgs_audio_3", "granite_speech_nar",
                                    "moss_music"])
def test_last_stt_transcription_by_directory(tmp_path, monkeypatch, family):
    """A tiny directory of each of the last six STT families (chip_smoke.py
    phase 53's small configs) served by path through the transcription
    route: the text of the directory's model's own generate(). The LM
    families read the stand-in AsrTok as their tokenizer; Higgs Audio v3
    cuts its chunks with the local Silero MLX_AUDIO_VAD_MODEL names."""
    import importlib

    from safetensors.numpy import save_file

    from chip_smoke import (LAST_STT_SMALL, SMALL_SPECIAL_IDS, AsrTok,
                            _stt_small, _write_kaldi_dir)
    from mlx_audio_tpu_torch.server import AudioServer
    from mlx_audio_tpu_torch.stt.utils import load_model
    from mlx_audio_tpu_torch.vad.models.silero_vad import Model as Silero
    from mlx_audio_tpu_torch.vad.models.silero_vad import ModelConfig

    pkg = importlib.import_module(f"mlx_audio_tpu_torch.stt.models.{family}")
    module = importlib.import_module(pkg.Model.__module__)
    monkeypatch.setattr(module, "local_tokenizer", lambda path, **kw: AsrTok(
        SMALL_SPECIAL_IDS, n_chars=200))
    vad = tmp_path / "silero_vad"
    vad.mkdir()
    save_file({k: v.numpy() for k, v in Silero(ModelConfig(), device="cpu")
               .init_params(seed=0).state_dict().items()},
              str(vad / "model.safetensors"))
    monkeypatch.setenv("MLX_AUDIO_VAD_MODEL", str(vad))
    d = tmp_path / f"{family}-tiny"
    _write_kaldi_dir(_stt_small(family, "cpu"), d, LAST_STT_SMALL[family])
    audio = (np.random.RandomState(17).randn(24000) * 0.1).astype(np.float32)
    wav = _wav(audio, 16000)

    async def go():
        server = AudioServer(device="cpu")
        try:
            return await server.transcribe(
                {"model": str(d), "response_format": "json",
                 "max_tokens": "16"}, wav)
        finally:
            server.close()

    reply = _run(go())
    assert reply.status == 200, reply.json
    want = load_model(d, device="cpu").generate(_read(wav)[0], max_tokens=16)
    assert want.text and reply.json["text"] == want.text


def test_vyvotts_speech_by_directory(tmp_path, monkeypatch):
    """A tiny VyvoTTS directory (its SNAC in snac/, the stand-in tokenizer)
    served by path through /v1/audio/speech: the WAV of the directory's
    model's own greedy generate()."""
    from mlx_audio_tpu_torch.server import AudioServer
    from mlx_audio_tpu_torch.tts.models.qwen3 import qwen3
    from mlx_audio_tpu_torch.tts.utils import load_model
    from chip_smoke import write_vyvo_checkpoint
    from test_torch_vyvotts import CharTok
    from test_torch_vyvotts import models as vyvo_models

    d = tmp_path / "vyvotts-tiny"
    write_vyvo_checkpoint(vyvo_models.__wrapped__()[1], d)
    monkeypatch.setattr(qwen3, "local_tokenizer", lambda path: CharTok())

    async def go():
        server = AudioServer(device="cpu")
        try:
            reply = await server.speech({
                "model": str(d), "input": "hello world", "voice": "zoe",
                "temperature": 0.0, "max_tokens": 16, "seed": 0})
            return reply.status, await reply.read()
        finally:
            server.close()

    status, body = _run(go())
    assert status == 200
    got, sr = _read(body)
    model = load_model(d, device="cpu")
    (want,) = list(model.generate("hello world", voice="zoe",
                                  temperature=0.0, max_tokens=16, seed=0))
    assert sr == 24000 and len(got) == want.samples > 0
    np.testing.assert_allclose(got, np.clip(want.audio, -1, 1),
                               atol=2 / 32768)
