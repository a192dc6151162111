"""OpenAI-compatible REST + WebSocket audio server of the port.

Counterpart of mlx_audio_tpu/server.py: `ModelProvider` over the port's
`load_model`, the TTS, STT and separation adapters on the port's
`InferenceBroker`, and the endpoints: health, models (list, load,
unload), voices (the voice library), `POST /v1/audio/speech` (wav and pcm,
whole and streamed), `POST /v1/audio/transcriptions` (json, text,
verbose_json, srt, vtt, NDJSON streaming), `POST /v1/audio/separations`,
`WS /v1/audio/transcriptions/realtime`, `WS /v1/realtime` (manual commit
and `server_vad` turn detection with pre-roll flush, the transcription
delay forwarded to streaming sessions), CORS, the CLI's environment bridge
and the studio UI at `/`.

    python -m mlx_audio_tpu_torch.server --port 8000            # the card
    python -m mlx_audio_tpu_torch.server --port 8000 --device cpu

Each endpoint's work lives in `AudioServer`, which never imports aiohttp:
from a parsed request (a dict, an upload's bytes, a WebSocket message) to
a `Reply` (status, JSON or bytes, headers, or an async iterator of byte
chunks), and for the WebSockets a session object fed one message at a
time that answers through an async `send` callback. aiohttp is imported
only by `create_app`, `main` and the thin route wrappers that turn an
aiohttp request into those inputs and a `Reply` into a response, so the
same request code runs without aiohttp.

Departures from the JAX server:
* models load onto one device (`--device`, default the card; without
  CUDA the server raises at start unless given `--device cpu`), from
  local directories only (the port never downloads);
* `--tensor-parallel N` with N > 1 raises: the port has no
  multi-device path yet;
* a session warm-up failure is logged with its traceback (the JAX server
  swallows it), and so is a VAD model that fails to load;
* a model that has no implementation for a request's option (it raises
  NotImplementedError) answers 501 with the model's message; requests
  with `ref_audio` never join a continuous-batching session, which would
  drop it;
* the separation adapter takes any model with `separate(audio)` (the
  port's Mel-Band-RoFormer), besides SAM-Audio's text-guided branch;
* `/v1/realtime` makes each turn's new streaming session with the same
  transcription delay as the first.
"""

from __future__ import annotations

import argparse
import asyncio
import base64
import inspect
import io
import json
import logging
import os
import queue
import time
import uuid
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, AsyncIterator, Awaitable, Callable, Dict, List, Optional

import numpy as np

from . import audio_io
from .realtime_vad import (VAD_SAMPLE_RATE, ServerVadConfig, StreamingVad,
                           TurnDetectionError, TurnEventKind,
                           parse_turn_detection)
from .server_inference import (BaseModelExecutionAdapter, InferenceBroker,
                               InferenceRequest)
from .voice_store import VoiceStore, VoiceStoreError

logger = logging.getLogger(__name__)

Send = Callable[[dict], Awaitable[None]]


def _call_kwargs(fn, kwargs: dict) -> dict:
    """kwargs that `fn` accepts (all of them if it takes **kwargs)."""
    sig = inspect.signature(fn).parameters
    if any(p.kind == inspect.Parameter.VAR_KEYWORD for p in sig.values()):
        return dict(kwargs)
    return {k: v for k, v in kwargs.items() if k in sig}


# ---------------------------------------------------------------------------
# Model provider
# ---------------------------------------------------------------------------


class ModelProvider:
    """Loads and caches models by name on one device: the card by default;
    without CUDA it raises unless given `device="cpu"`.

    The JAX server's tensor parallelism (`--tensor-parallel`,
    MLX_AUDIO_TPU_TENSOR_PARALLEL) is not ported: N > 1 raises rather
    than serve on one device."""

    def __init__(self, tensor_parallel: Optional[int] = None,
                 device="cuda"):
        from .model import check_device

        env_tp = os.environ.get("MLX_AUDIO_TPU_TENSOR_PARALLEL")
        tp = tensor_parallel or (int(env_tp) if env_tp else None)
        if tp and tp > 1:
            raise ValueError(
                f"tensor_parallel={tp}: the port serves on one device; "
                f"multi-device serving is not ported yet (ROADMAP.md queue "
                f"1, item 9)")
        self.device = check_device(device)
        self._models: Dict[str, Any] = {}
        self._lock = asyncio.Lock()

    def loaded(self) -> List[str]:
        return sorted(self._models)

    def get_cached(self, name: str):
        return self._models.get(name)

    async def load(self, name: str, category: Optional[str] = None):
        async with self._lock:
            if name in self._models:
                return self._models[name]
            from .utils import load_model

            model = await asyncio.to_thread(load_model, name,
                                            category=category,
                                            device=self.device)
            self._models[name] = model
            return model

    def unload(self, name: str) -> bool:
        return self._models.pop(name, None) is not None


# ---------------------------------------------------------------------------
# Execution adapters (run on the broker's worker thread)
# ---------------------------------------------------------------------------


class TTSExecutionAdapter(BaseModelExecutionAdapter):
    """Runs model.generate on the broker thread, emitting audio chunks, or
    routes a request to the model's continuous-batching session. Only the
    kwargs the model's generate() accepts are forwarded."""

    max_batch_size = int(os.environ.get("MLX_AUDIO_TTS_MAX_BATCH_SIZE", "1"))

    def __init__(self, provider: ModelProvider):
        self.provider = provider

    def supports_continuous_batch(self, request) -> bool:
        if request.normalized_kwargs.get("ref_audio") is not None:
            return False
        model = self.provider.get_cached(request.model_name)
        checker = getattr(model, "supports_tts_continuous_batch", None)
        return bool(checker and checker())

    def continuous_batch_key(self, request) -> Any:
        return None

    def create_continuous_batch_session(self, request):
        from .tts.continuous import TTSBatchOptions

        model = self.provider.get_cached(request.model_name)
        kw = request.normalized_kwargs
        opts = TTSBatchOptions(
            max_batch_size=int(os.environ.get(
                "MLX_AUDIO_TTS_MAX_BATCH_SIZE", "4")),
            temperature=float(kw.get("temperature", 0.9)),
            top_k=int(kw.get("top_k", 50)),
            max_tokens=int(kw.get("max_tokens", 1200)),
            streaming_interval=float(kw.get("streaming_interval", 2.0)))
        sess = model.create_tts_batch_session(opts)
        # set up the session's buffers before the first real request joins
        # (the broker keeps the session alive across requests)
        warm = getattr(sess, "warmup", None)
        if callable(warm):
            try:
                warm()
            except Exception:
                logger.exception("TTS session warm-up failed for %s",
                                 request.model_name)
        return sess

    def run_serial(self, request: InferenceRequest) -> None:
        model = self.provider.get_cached(request.model_name)
        if model is None:
            raise ValueError(f"Model not loaded: {request.model_name}")
        kwargs = _call_kwargs(model.generate, request.normalized_kwargs)
        for result in model.generate(request.payload, **kwargs):
            if request.cancel_event.is_set():
                break
            audio = np.asarray(result.audio)
            if audio.size:
                request.emit_data({
                    "audio": audio,
                    "sample_rate": result.sample_rate,
                    "is_final": getattr(result, "is_final_chunk", False),
                })
        request.emit_done()


class STTExecutionAdapter(BaseModelExecutionAdapter):
    def __init__(self, provider: ModelProvider):
        self.provider = provider

    def run_serial(self, request: InferenceRequest) -> None:
        model = self.provider.get_cached(request.model_name)
        if model is None:
            raise ValueError(f"Model not loaded: {request.model_name}")
        kwargs = dict(request.normalized_kwargs)
        stream = bool(kwargs.pop("stream", False))
        sig = inspect.signature(model.generate).parameters
        kwargs = _call_kwargs(model.generate, kwargs)
        if stream and "stream" in sig:
            # chunked transcription: the model's streamed deltas
            for chunk in model.generate(request.payload, stream=True,
                                        **kwargs):
                if request.cancel_event.is_set():
                    break
                request.emit_data(chunk)
            request.emit_done()
            return
        request.emit_data(model.generate(request.payload, **kwargs))
        request.emit_done()


class SeparationExecutionAdapter(BaseModelExecutionAdapter):
    """Source separation on the broker thread: SAM-Audio by its text
    description (`_run_sam_audio`), or any model exposing
    `separate(audio)` -> result with `vocals` and `sample_rate`: target =
    the separated stem, residual = input - target."""

    def __init__(self, provider: ModelProvider):
        self.provider = provider

    def run_serial(self, request: InferenceRequest) -> None:
        model = self.provider.get_cached(request.model_name)
        if model is None:
            raise ValueError(f"Model not loaded: {request.model_name}")
        if not hasattr(model, "separate"):
            raise ValueError(
                f"Model {request.model_name} has no separate() API")
        if getattr(getattr(model, "config", None), "model_type", "") \
                == "sam_audio":
            self._run_sam_audio(request, model)
            return
        audio, sr = request.payload
        target_sr = getattr(getattr(model, "config", None), "sample_rate",
                            sr)
        x = np.asarray(audio, np.float32)
        if x.ndim == 1:
            x = np.stack([x, x])
        elif x.shape[0] != 2 and x.shape[-1] == 2:
            x = x.T
        if sr != target_sr:
            from .utils import resample_audio

            x = np.stack([resample_audio(ch, sr, target_sr) for ch in x])
        result = model.separate(x)
        target = np.asarray(result.vocals, np.float32)
        residual = x[:, : target.shape[1]] - target

        def b64(a):
            return base64.b64encode(
                _encode_wav(a.T, result.sample_rate)).decode()

        request.emit_data({"target": b64(target), "residual": b64(residual),
                           "sample_rate": result.sample_rate})
        request.emit_done()

    def _run_sam_audio(self, request: InferenceRequest, model) -> None:
        """Text-guided separation by SAM-Audio's `separate_long`: the
        upload mixed to mono and resampled to the model's rate, `steps`
        ODE steps by `method`, the request's `description` (the JAX
        server's branch, mlx_audio_tpu/server.py:225-285)."""
        audio, sr = request.payload
        kw = request.normalized_kwargs
        x = np.asarray(audio, np.float32)
        if x.ndim > 1:
            x = x.mean(axis=0)
        target_sr = model.sample_rate
        if sr != target_sr:
            from .utils import resample_audio

            x = np.asarray(resample_audio(x, sr, target_sr))
        steps = max(int(kw.get("steps", 16)), 1)
        res = model.separate_long(
            x[None, None], [kw.get("description", "speech")],
            ode_opt={"step_size": 1.0 / steps,
                     "method": kw.get("method", "midpoint")})

        def b64(a):
            return base64.b64encode(_encode_wav(
                np.asarray(a, np.float32).reshape(-1), target_sr)).decode()

        request.emit_data({"target": b64(res.target[0]),
                           "residual": b64(res.residual[0]),
                           "sample_rate": target_sr})
        request.emit_done()


# ---------------------------------------------------------------------------
# Request core (no aiohttp below this line until create_app)
# ---------------------------------------------------------------------------


@dataclass
class Reply:
    """An endpoint's answer: JSON (`json`), bytes (`body`), a file
    (`file`) or a streamed body (`stream`, an async iterator of bytes)."""

    status: int = 200
    json: Any = None
    body: Optional[bytes] = None
    text: Optional[str] = None
    content_type: Optional[str] = None
    headers: Dict[str, str] = field(default_factory=dict)
    file: Optional[Path] = None
    stream: Optional[AsyncIterator[bytes]] = None

    async def read(self) -> bytes:
        """The whole body as bytes (a streamed body drained)."""
        if self.stream is not None:
            return b"".join([c async for c in self.stream])
        if self.json is not None:
            return dumps(self.json).encode()
        if self.file is not None:
            return Path(self.file).read_bytes()
        if self.text is not None:
            return self.text.encode()
        return self.body or b""


def _error(message: str, status: int) -> Reply:
    return Reply(status=status, json={"error": message})


def _json_default(o):
    if isinstance(o, np.generic):
        return o.item()
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"{type(o).__name__} is not JSON serializable")


def dumps(obj) -> str:
    """json.dumps that also takes numpy scalars and arrays."""
    return json.dumps(obj, default=_json_default)


def _encode_wav(audio: np.ndarray, sample_rate: int) -> bytes:
    buf = io.BytesIO()
    audio_io.write(buf, audio, sample_rate, format="wav")
    return buf.getvalue()


def _pcm16(audio: np.ndarray) -> bytes:
    return np.clip(np.round(np.asarray(audio) * 32768.0), -32768,
                   32767).astype("<i2").tobytes()


def _status_of(e: BaseException) -> int:
    """HTTP status for an inference error: 501 for what the model has no
    implementation of, else 500."""
    return 501 if isinstance(e, NotImplementedError) else 500


async def _drain_handle(handle, timeout: float = 600.0):
    """Async-iterate a broker request's result payloads."""
    deadline = time.time() + timeout
    while True:
        try:
            chunk = await asyncio.to_thread(handle.result_queue.get, True, 1.0)
        except queue.Empty:
            if time.time() > deadline:
                handle.cancel()
                raise TimeoutError("inference timed out")
            continue
        if chunk.kind == "error":
            raise chunk.error
        if chunk.kind == "done":
            return
        yield chunk.payload


def _truthy(v) -> bool:
    return str(v).lower() in ("1", "true", "yes", "on")


def cors_headers(origin: Optional[str]) -> Dict[str, str]:
    """CORS headers for a request from `origin`, per
    MLX_AUDIO_ALLOWED_ORIGINS (comma-separated, default "*")."""
    allowed = os.environ.get("MLX_AUDIO_ALLOWED_ORIGINS", "*")
    if not origin or not (allowed == "*" or origin in [
            o.strip() for o in allowed.split(",")]):
        return {}
    return {"Access-Control-Allow-Origin": origin if allowed != "*" else "*",
            "Access-Control-Allow-Methods": "GET, POST, DELETE, OPTIONS",
            "Access-Control-Allow-Headers": "Content-Type, Authorization"}


class AudioServer:
    """The server's state (models, broker, voice library) and every
    endpoint's work. Methods take parsed requests and return `Reply`s;
    the WebSocket endpoints return session objects (`open_realtime`,
    `open_transcription_stream`)."""

    def __init__(self, tensor_parallel: Optional[int] = None,
                 device="cuda"):
        self.provider = ModelProvider(tensor_parallel=tensor_parallel,
                                      device=device)
        self.broker = InferenceBroker()
        self.broker.register_adapter("tts", TTSExecutionAdapter(self.provider))
        self.broker.register_adapter("stt", STTExecutionAdapter(self.provider))
        self.broker.register_adapter(
            "separation", SeparationExecutionAdapter(self.provider))
        self.voices = VoiceStore()

    def close(self) -> None:
        self.broker.stop_and_join()

    # -- studio UI -----------------------------------------------------------

    def ui_index(self) -> Reply:
        from .ui import ui_static_dir

        return Reply(file=ui_static_dir() / "index.html")

    def ui_static(self, path: str) -> Reply:
        from .ui import ui_static_dir

        base = ui_static_dir().resolve()
        target = (base / path).resolve()
        if not str(target).startswith(str(base)) or not target.is_file():
            return _error("not found", 404)
        return Reply(file=target)

    # -- models ----------------------------------------------------------------

    def health(self) -> Reply:
        return Reply(json={"status": "ok"})

    def list_models(self) -> Reply:
        return Reply(json={"object": "list", "data": [
            {"id": m, "object": "model"} for m in self.provider.loaded()]})

    async def load_model(self, body: dict) -> Reply:
        name = body.get("model")
        if not name:
            return _error("missing 'model'", 400)
        try:
            await self.provider.load(name)
        except Exception as e:
            return _error(str(e), 404)
        return Reply(json={"id": name, "object": "model"})

    def unload_model(self, name: Optional[str]) -> Reply:
        if not name:
            return _error("missing 'model'", 400)
        if not self.provider.unload(name):
            return _error(f"model not loaded: {name}", 404)
        return Reply(json={"deleted": True, "id": name})

    # -- voices ----------------------------------------------------------------

    def list_voices(self) -> Reply:
        """Voices of the loaded models (voice files in their directory,
        speakers they name) and the voice library's."""
        voices = {}
        for name in self.provider.loaded():
            model = self.provider.get_cached(name)
            model_voices = []
            path = getattr(getattr(model, "config", None), "model_path", "")
            vdir = os.path.join(str(path), "voices") if path else ""
            if vdir and os.path.isdir(vdir):
                model_voices = sorted(
                    os.path.splitext(f)[0] for f in os.listdir(vdir)
                    if f.endswith((".safetensors", ".npy")))
            if hasattr(model, "get_supported_speakers"):
                model_voices += model.get_supported_speakers()
            voices[name] = model_voices
        return Reply(json={"voices": voices, "custom": self.voices.list()})

    def save_voice(self, body: dict) -> Reply:
        """Save a named reference voice: {"name", "audio" (base64 encoded
        audio), "ref_text"?}; usable as ref_audio="voice:<name>"."""
        name, audio_b64 = body.get("name"), body.get("audio")
        if not name or not audio_b64:
            return _error("'name' and 'audio' (base64) are required", 400)
        try:
            raw = base64.b64decode(audio_b64, validate=True)
            wav, sr = audio_io.read(io.BytesIO(raw), dtype="float32")
        except Exception:
            return _error("audio is not valid base64-encoded audio", 400)
        try:
            meta = self.voices.save(name, wav, sr,
                                    ref_text=body.get("ref_text"))
        except VoiceStoreError as e:
            return _error(str(e), 400)
        return Reply(status=201, json=meta)

    def get_voice(self, name: str) -> Reply:
        try:
            path = self.voices.wav_path(name)
        except VoiceStoreError as e:
            return _error(str(e), 400)
        if not path.is_file():
            return _error(f"no saved voice named {name!r}", 404)
        return Reply(file=path, headers={"Content-Type": "audio/wav"})

    def delete_voice(self, name: str) -> Reply:
        try:
            found = self.voices.delete(name)
        except VoiceStoreError as e:
            return _error(str(e), 400)
        if not found:
            return _error(f"no saved voice named {name!r}", 404)
        return Reply(json={"deleted": name})

    # -- TTS -----------------------------------------------------------------

    async def speech(self, body: dict) -> Reply:
        """POST /v1/audio/speech: {"model", "input", "response_format"
        (wav or pcm), "stream", the model's knobs, "ref_audio"?}."""
        text = body.get("input")
        model_name = body.get("model")
        if not text or not model_name:
            return _error("'model' and 'input' are required", 400)
        response_format = body.get("response_format", "wav")
        if response_format not in ("wav", "pcm"):
            return _error(f"unsupported response_format: {response_format} "
                          "(this build encodes wav/pcm natively; compressed "
                          "formats require ffmpeg)", 400)
        stream = bool(body.get("stream", False))
        kwargs = {}
        # the adapter forwards only what the model's generate() takes
        for k in ("voice", "speed", "lang_code", "language", "temperature",
                  "top_p", "top_k", "repetition_penalty", "max_tokens",
                  "seed", "instruct", "gender", "pitch", "ref_text",
                  "streaming_interval"):
            if body.get(k) is not None:
                kwargs[k] = body[k]
        if stream:
            kwargs["stream"] = True
        try:
            model = await self.provider.load(model_name, category="tts")
        except Exception as e:
            return _error(str(e), 404)

        # ref_audio: "voice:<name>" from the voice library, a server-local
        # path, or base64-encoded audio -> waveform at the model's rate
        ref_audio = body.get("ref_audio")
        target_sr = getattr(model, "sample_rate", 24000)
        if ref_audio:
            voice_name = self.voices.resolve_ref(ref_audio)
            if voice_name is not None:
                try:
                    kwargs["ref_audio"] = self.voices.load(
                        voice_name, sample_rate=target_sr)
                    stored_text = self.voices.meta(voice_name).get(
                        "ref_text")
                    if stored_text and "ref_text" not in kwargs:
                        kwargs["ref_text"] = stored_text
                except VoiceStoreError as e:
                    return _error(str(e), 404)
                ref_audio = None
        if ref_audio:
            try:
                if os.path.exists(ref_audio):
                    from .utils import load_audio

                    wav = load_audio(ref_audio, sample_rate=target_sr)
                else:
                    raw = base64.b64decode(ref_audio, validate=True)
                    wav, sr = audio_io.read(io.BytesIO(raw), dtype="float32")
                    if wav.ndim > 1:
                        wav = wav.mean(axis=1)
                    if sr != target_sr:
                        from .utils import resample_audio

                        wav = resample_audio(wav, sr, target_sr)
                kwargs["ref_audio"] = wav
            except Exception:
                return _error(f"reference audio not found or undecodable: "
                              f"{str(ref_audio)[:80]}", 404)

        handle = self.broker.submit(endpoint_kind="tts",
                                    model_name=model_name, payload=text,
                                    normalized_kwargs=kwargs, stream=stream)
        if stream:
            # the first payload's sample rate rides a header (a client's
            # progressive playback needs it before the audio)
            gen = _drain_handle(handle)
            try:
                first = await gen.__anext__()
            except StopAsyncIteration:
                return _error("no audio generated", 500)
            except Exception as e:
                return _error(str(e), _status_of(e))

            def encode(payload) -> bytes:
                if response_format == "pcm":
                    return _pcm16(payload["audio"])
                return _encode_wav(payload["audio"], payload["sample_rate"])

            async def chunks():
                try:
                    yield encode(first)
                    async for payload in gen:
                        yield encode(payload)
                except Exception as e:
                    yield dumps({"error": str(e)}).encode()

            return Reply(stream=chunks(), headers={
                "Content-Type": "audio/wav" if response_format == "wav"
                else "application/octet-stream",
                "X-Sample-Rate": str(first.get("sample_rate", 24000))})

        pieces, rate = [], 24000
        try:
            async for payload in _drain_handle(handle):
                pieces.append(payload["audio"])
                rate = payload["sample_rate"]
        except Exception as e:
            return _error(str(e), _status_of(e))
        if not pieces:
            return _error("no audio generated", 500)
        audio = np.concatenate(pieces)
        if response_format == "pcm":
            return Reply(body=_pcm16(audio),
                         content_type="application/octet-stream")
        return Reply(body=_encode_wav(audio, rate), content_type="audio/wav")

    # -- STT -----------------------------------------------------------------

    async def transcribe(self, fields: Dict[str, Any],
                         audio_bytes: Optional[bytes]) -> Reply:
        """POST /v1/audio/transcriptions: the form's fields (model,
        response_format, stream, the model's knobs) and the upload."""
        if audio_bytes is None:
            return _error("missing audio 'file'", 400)
        model_name = fields.get("model")
        if not model_name:
            return _error("missing 'model'", 400)
        response_format = fields.get("response_format", "json")
        try:
            await self.provider.load(model_name, category="stt")
        except Exception as e:
            return _error(str(e), 404)
        audio, sr = audio_io.read(io.BytesIO(audio_bytes), dtype="float32")
        if audio.ndim > 1:
            audio = audio.mean(axis=1)
        if sr != 16000:
            from .utils import resample_audio

            audio = resample_audio(audio, sr, 16000)
        # the adapter forwards only what the model's generate() takes
        kwargs = {}
        for k, cast in (("language", str), ("temperature", float),
                        ("max_tokens", int), ("chunk_duration", float),
                        ("frame_threshold", int), ("context", str),
                        ("prefill_step_size", int), ("text", str),
                        ("prompt", str), ("initial_prompt", str),
                        ("word_timestamps", _truthy),
                        ("timestamp_granularities", str)):
            v = fields.get(k)
            if v not in (None, ""):
                try:
                    kwargs[k] = cast(v)
                except (TypeError, ValueError):
                    pass
        stream_flag = _truthy(fields.get("stream", False))
        if stream_flag:
            kwargs["stream"] = True
        handle = self.broker.submit(endpoint_kind="stt",
                                    model_name=model_name, payload=audio,
                                    normalized_kwargs=kwargs,
                                    stream=stream_flag)

        if response_format == "ndjson":
            # one JSON object per line, as the model emits them
            async def lines():
                try:
                    async for payload in _drain_handle(handle):
                        line = {"text": payload.text}
                        if getattr(payload, "segments", None):
                            line["segments"] = payload.segments
                        if getattr(payload, "language", None):
                            line["language"] = payload.language
                        yield (dumps(line) + "\n").encode()
                except Exception as e:
                    yield (dumps({"error": str(e)}) + "\n").encode()

            return Reply(stream=lines(),
                         headers={"Content-Type": "application/x-ndjson"})

        output = None
        try:
            async for payload in _drain_handle(handle):
                if output is None:
                    output = payload
                else:  # streamed chunks: accumulate text + segments
                    output.text = (output.text or "") + (payload.text or "")
                    if getattr(payload, "segments", None):
                        output.segments = (list(output.segments or [])
                                           + list(payload.segments))
        except Exception as e:
            return _error(str(e), _status_of(e))
        if output is None:
            return _error("no transcription", 500)
        if response_format == "text":
            return Reply(text=output.text.strip(), content_type="text/plain")
        if response_format in ("srt", "vtt"):
            import tempfile

            from .stt.generate import save_as_srt, save_as_vtt

            with tempfile.TemporaryDirectory() as td:
                p = Path(td) / f"t.{response_format}"
                (save_as_srt if response_format == "srt" else save_as_vtt)(
                    output, p)
                return Reply(text=p.read_text(), content_type="text/plain")
        if response_format == "verbose_json":
            return Reply(json={"task": "transcribe",
                               "language": output.language,
                               "text": output.text,
                               "segments": output.segments})
        return Reply(json={"text": output.text})

    async def separate(self, fields: Dict[str, Any],
                       audio_bytes: Optional[bytes]) -> Reply:
        """POST /v1/audio/separations: {file, model, description, method,
        steps} -> base64 target/residual WAVs + sample_rate."""
        if audio_bytes is None:
            return _error("missing file", 400)
        model_name = fields.get("model") or os.environ.get(
            "MLX_AUDIO_SEPARATION_MODEL", "")
        if not model_name:
            return _error("no model specified", 400)
        try:
            await self.provider.load(model_name, category="sts")
        except Exception as e:
            return _error(str(e), 404)
        audio, sr = audio_io.read(io.BytesIO(audio_bytes))
        if audio.ndim > 1:
            audio = audio.T          # (channels, samples)
        handle = self.broker.submit(
            endpoint_kind="separation", model_name=model_name,
            payload=(audio, sr),
            normalized_kwargs={
                "description": fields.get("description", "speech"),
                "method": fields.get("method", "midpoint"),
                "steps": int(fields.get("steps", 16)),
            })
        try:
            async for payload in _drain_handle(handle):
                return Reply(json=payload)
        except Exception as e:
            return _error(str(e), _status_of(e))
        return _error("no result", 500)

    # -- WebSockets ------------------------------------------------------------

    async def open_transcription_stream(self, model_name: Optional[str],
                                        send: Send):
        """WS /v1/audio/transcriptions/realtime: a `TranscriptionStream`,
        or None after sending the error that ended it."""
        model_name = model_name or os.environ.get(
            "MLX_AUDIO_REALTIME_MODEL", "")
        if not model_name:
            await send({"type": "error", "error": "no model specified"})
            return None
        try:
            model = await self.provider.load(model_name, category="stt")
        except Exception as e:
            await send({"type": "error", "error": str(e)})
            return None
        return TranscriptionStream(model, send)

    async def open_realtime(self, model_name: Optional[str], send: Send):
        """WS /v1/realtime: a `RealtimeSession` (after its session.created
        event), or None after sending the error that ended it."""
        model_name = model_name or os.environ.get(
            "MLX_AUDIO_REALTIME_MODEL", "")
        model = None
        if model_name:
            try:
                model = await self.provider.load(model_name, category="stt")
            except Exception as e:
                await send({"type": "error", "error": {"message": str(e)}})
                return None
        vad_model = None
        vad_model_name = os.environ.get("MLX_AUDIO_VAD_MODEL", "")
        if vad_model_name:
            try:
                vad_model = await self.provider.load(vad_model_name,
                                                     category="vad")
            except Exception:
                logger.exception("VAD model %s failed to load; /v1/realtime "
                                 "runs with manual commit", vad_model_name)
        session = RealtimeSession(model, model_name, vad_model, send)
        await session.start()
        return session


class TranscriptionStream:
    """WS /v1/audio/transcriptions/realtime: binary int16 PCM appends to a
    buffer; {"type": "commit"} transcribes it, {"type": "close"} ends."""

    def __init__(self, model, send: Send):
        self.model = model
        self.send = send
        self.buffer = np.zeros(0, np.float32)

    def on_audio(self, data: bytes) -> None:
        pcm = np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0
        self.buffer = np.concatenate([self.buffer, pcm])

    async def on_message(self, data: dict) -> bool:
        """Handle one text message; False once the client asked to close."""
        if data.get("type") == "commit" and len(self.buffer) > 1600:
            audio, self.buffer = self.buffer, np.zeros(0, np.float32)
            out = await asyncio.to_thread(self.model.generate, audio)
            await self.send({"type": "transcription",
                             "text": out.text.strip()})
        elif data.get("type") == "close":
            return False
        return True


class RealtimeSession:
    """WS /v1/realtime, OpenAI's Realtime protocol for input transcription:
    session.update (turn_detection), input_audio_buffer.append / commit /
    clear, session.close. With a VAD model, `server_vad` turn detection
    (speech_started / speech_stopped, a 0.5-s pre-roll flushed into the
    turn); without one, manual commit. A model with a streaming session
    (feed / step / close) is fed as audio arrives and its deltas are
    sent; any other model transcribes each turn's buffer whole. The
    model's and the VAD's steps run in worker threads (asyncio.to_thread).
    """

    def __init__(self, model, model_name: str, vad_model, send: Send):
        self.model = model
        self.model_name = model_name
        self.send = send
        self.session_id = f"sess_{uuid.uuid4().hex[:16]}"
        self.vad_config: Optional[ServerVadConfig] = ServerVadConfig()
        self.svad = (StreamingVad(vad_model, self.vad_config)
                     if vad_model is not None else None)
        self.audio_buf = np.zeros(0, np.float32)
        self.preroll = np.zeros(0, np.float32)
        self.feeding = self.svad is None  # no VAD -> manual commit mode
        self.item_id = 0
        # a true streaming session where the model has one, with the
        # transcription delay where its factory declares it
        self.make_session = getattr(model, "create_streaming_session", None)
        self.session_kwargs: Dict[str, Any] = {}
        self.session = None
        if callable(self.make_session):
            delay_raw = os.getenv("MLX_AUDIO_REALTIME_TRANSCRIPTION_DELAY_MS")
            if delay_raw:
                sig = inspect.signature(self.make_session).parameters
                if "transcription_delay_ms" in sig or any(
                        p.kind == inspect.Parameter.VAR_KEYWORD
                        for p in sig.values()):
                    self.session_kwargs["transcription_delay_ms"] = int(
                        delay_raw)
            self.session = self.make_session(**self.session_kwargs)

    async def start(self) -> None:
        await self.send({
            "type": "session.created",
            "session": {"id": self.session_id, "model": self.model_name,
                        "turn_detection": self.vad_config.to_dict()
                        if self.vad_config else None}})

    async def _drain_deltas(self) -> None:
        if self.session is None:
            return
        for ev in await asyncio.to_thread(self.session.step):
            if ev.kind == "delta":
                await self.send({
                    "type": "conversation.item.input_audio_transcription."
                            "delta", "delta": ev.text})

    async def finalize_turn(self) -> None:
        self.item_id += 1
        item = f"item_{self.item_id}"
        # the commit acknowledgement and the item precede the transcript
        await self.send({"type": "input_audio_buffer.committed",
                         "item_id": item})
        await self.send({"type": "conversation.item.added",
                         "item": {"id": item, "type": "message",
                                  "role": "user"}})
        if self.session is not None:
            session = self.session
            session.close()
            final_text = session.text
            while not session.done:
                for ev in await asyncio.to_thread(session.step):
                    if ev.kind == "final":
                        final_text = ev.text
            await self.send({
                "type": "conversation.item.input_audio_transcription."
                        "completed", "item_id": item,
                "transcript": final_text.strip()})
            self.session = self.make_session(**self.session_kwargs)
            self.audio_buf = np.zeros(0, np.float32)
            return
        if self.model is None or len(self.audio_buf) < 1600:
            self.audio_buf = np.zeros(0, np.float32)
            return
        audio, self.audio_buf = self.audio_buf, np.zeros(0, np.float32)
        out = await asyncio.to_thread(self.model.generate, audio)
        await self.send({
            "type": "conversation.item.input_audio_transcription.completed",
            "item_id": item, "transcript": out.text.strip()})

    async def _feed(self, pcm: np.ndarray) -> None:
        if self.session is not None:
            self.session.feed(pcm)
            await self._drain_deltas()
        else:
            self.audio_buf = np.concatenate([self.audio_buf, pcm])

    async def on_text(self, raw: str) -> bool:
        """One text frame; False once the client closed the session."""
        try:
            event = json.loads(raw)
        except json.JSONDecodeError:
            await self.send({"type": "error",
                             "error": {"message": "invalid JSON"}})
            return True
        return await self.on_event(event)

    async def on_event(self, event: dict) -> bool:
        """One client event; False once the client closed the session."""
        etype = event.get("type")
        if etype == "session.update":
            td = event.get("session", {}).get("turn_detection", "missing")
            if td != "missing":
                try:
                    self.vad_config = parse_turn_detection(td)
                except TurnDetectionError as e:
                    await self.send({"type": "error",
                                     "error": {"message": str(e)}})
                    return True
                if self.vad_config is None:
                    self.svad, self.feeding = None, True
                elif self.svad is not None:
                    self.svad = StreamingVad(self.svad._vad, self.vad_config)
            await self.send({"type": "session.updated",
                             "session": {"id": self.session_id}})
        elif etype == "input_audio_buffer.append":
            pcm = np.frombuffer(base64.b64decode(event.get("audio", "")),
                                dtype="<i2").astype(np.float32) / 32768.0
            await self.append(pcm)
        elif etype == "input_audio_buffer.commit":
            await self.finalize_turn()
        elif etype == "input_audio_buffer.clear":
            self.audio_buf = np.zeros(0, np.float32)
            await self.send({"type": "input_audio_buffer.cleared"})
        elif etype == "session.close":
            return False
        return True

    async def append(self, pcm: np.ndarray) -> None:
        """Audio in: through the VAD's turn events when it runs, else into
        the turn."""
        if self.svad is None:
            await self._feed(pcm)
            return
        for ev in await asyncio.to_thread(self.svad.process, pcm):
            if ev.kind == TurnEventKind.SPEECH_STARTED:
                self.feeding = True
                if self.session is not None and len(self.preroll):
                    self.session.feed(self.preroll)
                else:
                    self.audio_buf = np.concatenate([self.audio_buf,
                                                     self.preroll])
                self.preroll = np.zeros(0, np.float32)
                await self.send({"type": "input_audio_buffer.speech_started",
                                 "audio_start_ms": ev.audio_ms})
            elif ev.kind == TurnEventKind.SPEECH_STOPPED:
                await self.send({"type": "input_audio_buffer.speech_stopped",
                                 "audio_end_ms": ev.audio_ms})
                await self.finalize_turn()
                self.feeding = False
        if self.feeding:
            await self._feed(pcm)
        else:
            # keep a pre-roll so that speech onsets are not clipped
            keep = int(VAD_SAMPLE_RATE * 0.5)
            self.preroll = np.concatenate([self.preroll, pcm])[-keep:]


# ---------------------------------------------------------------------------
# aiohttp: the app, its thin route wrappers and the CLI
# ---------------------------------------------------------------------------


def create_app(tensor_parallel: Optional[int] = None, device="cuda",
               server: Optional[AudioServer] = None):
    """The aiohttp application over `server` (a new `AudioServer` on
    `device` when None); its cleanup stops the server's broker."""
    from aiohttp import WSMsgType, web

    server = server or AudioServer(tensor_parallel=tensor_parallel,
                                   device=device)

    def respond(reply: Reply):
        if reply.file is not None:
            return web.FileResponse(reply.file, status=reply.status,
                                    headers=reply.headers or None)
        if reply.json is not None:
            return web.json_response(reply.json, status=reply.status,
                                     headers=reply.headers or None,
                                     dumps=dumps)
        if reply.text is not None:
            return web.Response(text=reply.text, status=reply.status,
                                content_type=reply.content_type)
        return web.Response(body=reply.body, status=reply.status,
                            content_type=reply.content_type,
                            headers=reply.headers or None)

    async def send_reply(request, reply: Reply):
        if reply.stream is None:
            return respond(reply)
        resp = web.StreamResponse(status=reply.status, headers={
            **reply.headers, "Transfer-Encoding": "chunked"})
        await resp.prepare(request)
        async for chunk in reply.stream:
            await resp.write(chunk)
        await resp.write_eof()
        return resp

    async def json_body(request) -> Optional[dict]:
        try:
            body = await request.json()
        except Exception:
            return None
        return body if isinstance(body, dict) else None

    @web.middleware
    async def cors(request, handler):
        if request.method == "OPTIONS":
            resp = web.Response(status=204)
        else:
            resp = await handler(request)
        resp.headers.update(cors_headers(request.headers.get("Origin")))
        return resp

    async def load_model(request):
        body = await json_body(request)
        return respond(await server.load_model(body or {}))

    async def unload_body(request):
        name = request.query.get("model")
        if not name:
            name = (await json_body(request) or {}).get("model")
        return respond(server.unload_model(name))

    async def save_voice(request):
        body = await json_body(request)
        if body is None:
            return respond(_error("invalid JSON body", 400))
        return respond(server.save_voice(body))

    async def speech(request):
        body = await json_body(request)
        if body is None:
            return respond(_error("invalid JSON body", 400))
        return await send_reply(request, await server.speech(body))

    async def transcriptions(request):
        fields: Dict[str, Any] = {}
        audio_bytes = None
        if request.content_type.startswith("multipart/"):
            async for part in await request.multipart():
                data = await part.read(decode=False)
                if part.name == "file":
                    audio_bytes = data
                else:
                    fields[part.name] = data.decode()
        else:
            fields = dict(await json_body(request) or {})
            if "file" in fields:
                audio_bytes = base64.b64decode(fields.pop("file"))
        return await send_reply(request,
                                await server.transcribe(fields, audio_bytes))

    async def separations(request):
        form = await request.post()
        upload = form.get("file")
        fields = {k: v for k, v in form.items() if k != "file"}
        data = upload.file.read() if upload is not None else None
        return respond(await server.separate(fields, data))

    async def ws_transcriptions(request):
        ws = web.WebSocketResponse()
        await ws.prepare(request)
        stream = await server.open_transcription_stream(
            request.query.get("model"), ws.send_json)
        if stream is not None:
            async for msg in ws:
                if msg.type == WSMsgType.BINARY:
                    stream.on_audio(msg.data)
                elif msg.type == WSMsgType.TEXT:
                    if not await stream.on_message(json.loads(msg.data)):
                        break
        await ws.close()
        return ws

    async def ws_realtime(request):
        ws = web.WebSocketResponse()
        await ws.prepare(request)
        session = await server.open_realtime(request.query.get("model"),
                                             ws.send_json)
        if session is not None:
            async for msg in ws:
                if msg.type == WSMsgType.TEXT and \
                        not await session.on_text(msg.data):
                    break
        await ws.close()
        return ws

    async def stop_broker(app):
        await asyncio.to_thread(server.close)

    app = web.Application(client_max_size=512 * 1024 * 1024,
                          middlewares=[cors])
    app.on_cleanup.append(stop_broker)
    def sync(endpoint):
        """A route for an endpoint that does no I/O: request -> Reply."""
        async def handler(request):
            return respond(endpoint(request))
        return handler

    r = app.router
    r.add_get("/health", sync(lambda q: server.health()))
    r.add_get("/v1/models", sync(lambda q: server.list_models()))
    r.add_post("/v1/models", load_model)
    r.add_delete("/v1/models", unload_body)
    r.add_delete("/v1/models/{model_id:.*}", sync(
        lambda q: server.unload_model(q.match_info["model_id"])))
    r.add_get("/v1/audio/voices", sync(lambda q: server.list_voices()))
    r.add_post("/v1/audio/voices", save_voice)
    r.add_get("/v1/audio/voices/{name}", sync(
        lambda q: server.get_voice(q.match_info["name"])))
    r.add_delete("/v1/audio/voices/{name}", sync(
        lambda q: server.delete_voice(q.match_info["name"])))
    r.add_post("/v1/audio/speech", speech)
    r.add_post("/v1/audio/transcriptions", transcriptions)
    r.add_post("/v1/audio/separations", separations)
    r.add_get("/v1/audio/transcriptions/realtime", ws_transcriptions)
    r.add_get("/v1/realtime", ws_realtime)
    r.add_get("/", sync(lambda q: server.ui_index()))
    r.add_get("/ui/{path:.*}", sync(
        lambda q: server.ui_static(q.match_info["path"])))
    return app


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="mlx_audio_tpu_torch server")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--device", default="cuda",
                        help="Device the models load onto (default: cuda)")
    parser.add_argument("--tensor-parallel", type=int, default=None,
                        help="Not ported: N > 1 is refused")
    parser.add_argument("--allowed-origins", nargs="+", default=None,
                        help="CORS origins (MLX_AUDIO_ALLOWED_ORIGINS)")
    parser.add_argument("--realtime-model", type=str, default=None,
                        help="Default model for /v1/realtime "
                             "(MLX_AUDIO_REALTIME_MODEL)")
    parser.add_argument("--realtime-transcription-delay-ms", type=int,
                        default=None,
                        help="Streaming transcription delay override "
                             "(MLX_AUDIO_REALTIME_TRANSCRIPTION_DELAY_MS)")
    parser.add_argument("--vad-model", type=str, default=None,
                        help="VAD model for server turn detection "
                             "(MLX_AUDIO_VAD_MODEL)")
    parser.add_argument("--tts-max-batch-size", type=int, default=None,
                        help="Continuous-batch slot count "
                             "(MLX_AUDIO_TTS_MAX_BATCH_SIZE)")
    parser.add_argument("--realtime", action="store_true",
                        help="Accepted for compatibility; /v1/realtime is "
                             "always served")
    parser.add_argument("--start-ui", action="store_true",
                        help="Accepted for compatibility; the studio UI is "
                             "always served at /")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    _bridge_cli_env(args)
    server = AudioServer(tensor_parallel=args.tensor_parallel,
                         device=args.device)
    from aiohttp import web

    print(f"Studio UI available at http://{args.host}:{args.port}/")
    web.run_app(create_app(server=server), host=args.host, port=args.port)


def _bridge_cli_env(args) -> None:
    """The CLI's flags onto the environment variables the endpoints read."""
    if args.allowed_origins:
        os.environ["MLX_AUDIO_ALLOWED_ORIGINS"] = ",".join(
            args.allowed_origins)
    if args.realtime_model:
        os.environ["MLX_AUDIO_REALTIME_MODEL"] = args.realtime_model
    if args.realtime_transcription_delay_ms is not None:
        os.environ["MLX_AUDIO_REALTIME_TRANSCRIPTION_DELAY_MS"] = str(
            args.realtime_transcription_delay_ms)
    if args.vad_model:
        os.environ["MLX_AUDIO_VAD_MODEL"] = args.vad_model
    if args.tts_max_batch_size is not None:
        os.environ["MLX_AUDIO_TTS_MAX_BATCH_SIZE"] = str(
            args.tts_max_batch_size)


if __name__ == "__main__":
    main()
