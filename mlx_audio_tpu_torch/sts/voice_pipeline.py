"""Local voice-assistant pipeline: mic -> VAD -> STT -> LLM -> TTS -> speaker.

Counterpart of mlx_audio_tpu/sts/voice_pipeline.py on the port's models:
the device-work scheduler (one thread owns the card's work), Silero VAD
hysteresis with a smart-turn candidate (`SileroVoiceActivityDetector`
:90, over the port's `SileroVAD.feed`), the semantic endpoint
(`SmartTurnEndpointDetector` :73, over the port's Smart Turn
`predict_endpoint`), the llama reply (`LocalLLMResponseEngine` :140),
turn finalization, streamed TTS, barge-in and echo suppression
(`VoicePipeline` :194, the port's `sts.audio_player`), and `main` (:370)
on the port's `load_model`, local directories only, on `--device` (the
card by default). Headless use: `feed_audio()` and `fetch_speech()`. It
mirrors mlx-audio's sts/voice_pipeline.py.

Departures from the JAX package, in `LocalLLMResponseEngine`:
* the decode runs on the model's device in chunks of `DECODE_CHUNK` steps
  with one read of the chunk's tokens (JAX reads each token with
  `int()`); a chunk may run up to DECODE_CHUNK - 1 steps past an EOS, whose
  tokens are dropped. Sampled draws come from a `torch.Generator` on the
  device seeded 0 (JAX splits PRNGKey(0)); greedy replies equal JAX's;
* with a model bound and no tokenizer it raises, where JAX answers the
  "You said: ..." echo as if no model were bound. With no model bound the
  echo is the documented behaviour, kept.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np
import torch

VAD_FRAME = 512
DECODE_CHUNK = 8
SAMPLE_RATE = 16000


class DeviceWorkScheduler:
    """Single worker thread owning all device work (reference
    MLXWorkScheduler :106-141)."""

    def __init__(self):
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="device-work")

    def submit(self, fn: Callable, *args, **kwargs):
        return self._pool.submit(fn, *args, **kwargs)

    def run(self, fn: Callable, *args, **kwargs):
        return self._pool.submit(fn, *args, **kwargs).result()

    def shutdown(self):
        self._pool.shutdown(wait=False)


@dataclass
class VadConfig:
    start_threshold: float = 0.6
    stop_threshold: float = 0.35
    min_silence_ms: float = 600.0
    preroll_ms: float = 300.0
    # a shorter pause that asks the smart-turn model whether the turn is
    # semantically complete (reference voice_pipeline.py:1140-1162)
    candidate_silence_ms: float = 240.0
    # echo-correlation barge-in guard (reference :544-565,711)
    ignore_playback_echo_ms: float = 400.0
    echo_correlation_threshold: float = 0.55
    echo_delay_min_ms: float = 40.0
    echo_delay_max_ms: float = 400.0
    echo_correlation_step_ms: float = 32.0
    echo_window_ms: float = 320.0


@dataclass
class EndpointDecision:
    complete: bool
    probability: float


class SmartTurnEndpointDetector:
    """Semantic end-of-turn classifier wrapper
    (reference voice_pipeline.py:287-306)."""

    def __init__(self, model, *, sample_rate: int = SAMPLE_RATE,
                 threshold: Optional[float] = None):
        self.model = model
        self.sample_rate = sample_rate
        self.threshold = threshold

    def predict(self, audio: np.ndarray) -> EndpointDecision:
        result = self.model.predict_endpoint(
            audio, sample_rate=self.sample_rate, threshold=self.threshold)
        return EndpointDecision(complete=bool(result.prediction),
                                probability=float(result.probability))


class SileroVoiceActivityDetector:
    """Hysteresis start/stop wrapper over the streaming Silero model
    (reference :232-298)."""

    def __init__(self, vad_model, config: VadConfig = VadConfig()):
        self.model = vad_model
        self.config = config
        self.state = None
        self.in_speech = False
        self.silence_ms = 0.0
        self._candidate_fired = False

    def process(self, frame: np.ndarray):
        """One 512-sample frame -> (prob, started, stopped, candidate).

        `candidate` fires once per pause when silence exceeds
        candidate_silence_ms (smart-turn check point) before the full
        min_silence_ms stop."""
        prob_arr, self.state = self.model.feed(frame, self.state)
        prob = float(torch.as_tensor(prob_arr).reshape(-1)[0])
        frame_ms = 1000.0 * len(frame) / SAMPLE_RATE
        started = stopped = candidate = False
        if not self.in_speech:
            if prob >= self.config.start_threshold:
                self.in_speech = True
                self.silence_ms = 0.0
                self._candidate_fired = False
                started = True
        elif prob < self.config.stop_threshold:
            self.silence_ms += frame_ms
            if (not self._candidate_fired
                    and self.silence_ms >= self.config.candidate_silence_ms):
                self._candidate_fired = True
                candidate = True
            if self.silence_ms >= self.config.min_silence_ms:
                self.in_speech = False
                self.silence_ms = 0.0
                stopped = True
        else:
            self.silence_ms = 0.0
            self._candidate_fired = False
        return prob, started, stopped, candidate

    def reset(self):
        self.state = None
        self.in_speech = False
        self.silence_ms = 0.0
        self._candidate_fired = False


class LocalLLMResponseEngine:
    """Generate an assistant reply with a bound llama LM (the port's
    `tts.models.llama.Model`) and its tokenizer (reference
    LocalLLMResponseEngine :404-431)."""

    def __init__(self, model, tokenizer=None, max_tokens: int = 128,
                 temperature: float = 0.7):
        self.model = model
        self.tokenizer = tokenizer
        self.max_tokens = max_tokens
        self.temperature = temperature
        self.last_run: dict = {}

    @torch.inference_mode()
    def generate(self, user_text: str, history: List[dict]) -> str:
        if self.model is None:
            return f"You said: {user_text}"  # echo fallback (no LM bound)
        if self.tokenizer is None:
            raise ValueError("LocalLLMResponseEngine: a model is bound but no "
                             "tokenizer; set one to encode the prompt")
        from ..tts.models.llama.llama import (
            decode_step,
            init_caches,
            llama_forward,
            logits_from_hidden,
        )

        lm = self.model
        prompt = "".join(
            f"<|{m['role']}|>{m['content']}" for m in history[-4:]
        ) + f"<|user|>{user_text}<|assistant|>"
        ids = self.tokenizer.encode(prompt)
        dev = lm.device
        caches = init_caches(lm.config, 1, len(ids) + self.max_tokens,
                             device=dev)
        toks = torch.as_tensor([ids], dtype=torch.long, device=dev)
        hidden, caches = llama_forward(lm, toks, caches=caches, offset=0)
        logits = logits_from_hidden(lm, hidden)[:, -1]
        gen = torch.Generator(device=dev).manual_seed(0)
        eos = getattr(self.tokenizer, "eos_token_id", -1)
        out: List[int] = []
        steps = reads = 0
        while steps < self.max_tokens:
            n = min(DECODE_CHUNK, self.max_tokens - steps)
            picked = []
            for i in range(n):
                if self.temperature <= 0:
                    nxt = torch.argmax(logits, dim=-1)
                else:
                    probs = torch.softmax(logits.float() / self.temperature,
                                          dim=-1)
                    nxt = torch.multinomial(probs, 1, generator=gen)[:, 0]
                picked.append(nxt)
                if steps + i + 1 < self.max_tokens:
                    logits, caches = decode_step(lm, nxt[:, None], caches,
                                                 offset=len(ids) + steps + i)
            steps += n
            chunk = torch.stack(picked, dim=1)[0].tolist()
            reads += 1
            if eos in chunk:
                out.extend(chunk[:chunk.index(eos)])
                break
            out.extend(chunk)
        self.last_run = {"prompt": len(ids), "steps": steps, "reads": reads,
                         "tokens": len(out)}
        return self.tokenizer.decode(out)


class VoicePipeline:
    """Full-duplex voice assistant loop over pluggable components."""

    def __init__(
        self,
        vad_model=None,
        stt_model=None,
        llm_engine: Optional[LocalLLMResponseEngine] = None,
        tts_model=None,
        tts_voice: Optional[str] = None,
        smart_turn_model=None,
        on_event: Optional[Callable[[str, dict], None]] = None,
        vad_config: VadConfig = VadConfig(),
        clock: Optional[Callable[[], float]] = None,
    ):
        from .audio_player import AudioOutputStream

        self.scheduler = DeviceWorkScheduler()
        self.vad = (SileroVoiceActivityDetector(vad_model, vad_config)
                    if vad_model is not None else None)
        self.vad_config = vad_config
        self.stt = stt_model
        self.llm = llm_engine or LocalLLMResponseEngine(None)
        self.tts = tts_model
        self.tts_voice = tts_voice
        self.endpoint_detector = (
            SmartTurnEndpointDetector(smart_turn_model)
            if smart_turn_model is not None else None)
        self.on_event = on_event or (lambda kind, data: None)
        self.clock = clock or time.monotonic
        self.history: List[dict] = []
        self._buffer = np.zeros(0, np.float32)
        self._turn_audio = np.zeros(0, np.float32)
        self._preroll = np.zeros(0, np.float32)
        self.audio_output = AudioOutputStream(
            sample_rate=(getattr(tts_model, "sample_rate", SAMPLE_RATE)
                         if tts_model is not None else SAMPLE_RATE),
            clock=self.clock)
        self._speaking = threading.Event()
        self._input_ms = 0.0  # running mic clock (ms of audio consumed)

    # -- input path ----------------------------------------------------------

    def feed_audio(self, samples: np.ndarray) -> None:
        """Push 16 kHz float32 mic samples (headless or callback use)."""
        self._buffer = np.concatenate(
            [self._buffer, np.asarray(samples, np.float32).reshape(-1)])
        while len(self._buffer) >= VAD_FRAME:
            frame = self._buffer[:VAD_FRAME]
            self._buffer = self._buffer[VAD_FRAME:]
            self._process_frame(frame)

    def _process_frame(self, frame: np.ndarray) -> None:
        self._input_ms += 1000.0 * len(frame) / SAMPLE_RATE
        if self.vad is None:
            self._turn_audio = np.concatenate([self._turn_audio, frame])
            return
        prob, started, stopped, candidate = self.vad.process(frame)
        if started:
            # barge-in: cancel current speech when the user starts talking —
            # unless the "speech" is our own playback echoing back
            if self._playing_now():
                if self._looks_like_echo(frame):
                    self.on_event("echo_suppressed", {})
                    self.vad.in_speech = False
                    return
                self._handle_barge_in()
            self._turn_audio = self._preroll.copy()
            self.on_event("speech_started", {})
        if self.vad.in_speech or stopped:
            self._turn_audio = np.concatenate([self._turn_audio, frame])
        else:
            keep = int(SAMPLE_RATE * self.vad.config.preroll_ms / 1000)
            self._preroll = np.concatenate([self._preroll, frame])[-keep:]
        if stopped:
            self.on_event("speech_stopped", {})
            self.finalize_turn()
        elif candidate and self.endpoint_detector is not None:
            decision = self.scheduler.run(
                self.endpoint_detector.predict, self._turn_audio)
            self.on_event("endpoint_candidate",
                          {"complete": decision.complete,
                           "probability": decision.probability})
            if decision.complete:
                # semantic end of turn: finalize without waiting out the
                # full min_silence window (reference :1148-1162)
                self.vad.in_speech = False
                self.vad.silence_ms = 0.0
                self.on_event("speech_stopped", {"early": True})
                self.finalize_turn()

    def _playing_now(self) -> bool:
        state = self.audio_output.playback_state()
        if self._speaking.is_set() or state["player_playing"]:
            return True
        age = state.get("last_output_age_ms")
        return age is not None and \
            -50.0 <= age <= self.vad_config.ignore_playback_echo_ms

    def _looks_like_echo(self, frame: np.ndarray) -> bool:
        """Correlate recent mic input against our own output history
        (reference :544-565,711-726)."""
        win = int(SAMPLE_RATE * self.vad_config.echo_window_ms / 1000)
        recent = np.concatenate([self._preroll, frame])[-win:]
        best = self.audio_output.echo_correlation(
            recent, input_sample_rate=SAMPLE_RATE,
            input_end_ms=self.clock() * 1000.0,
            min_delay_ms=self.vad_config.echo_delay_min_ms,
            max_delay_ms=self.vad_config.echo_delay_max_ms,
            step_ms=self.vad_config.echo_correlation_step_ms)
        return best["correlation"] >= \
            self.vad_config.echo_correlation_threshold

    def _handle_barge_in(self) -> None:
        """Stop speaking and drop queued speech (reference :1207-1246)."""
        self._speaking.clear()
        self.audio_output.stop()
        self.on_event("barge_in", {})

    # -- turn handling -------------------------------------------------------

    def finalize_turn(self) -> Optional[str]:
        """Transcribe the buffered turn, respond, and synthesize speech."""
        audio = self._turn_audio
        self._turn_audio = np.zeros(0, np.float32)
        if len(audio) < SAMPLE_RATE // 10:
            return None
        text = ""
        if self.stt is not None:
            out = self.scheduler.run(self.stt.generate, audio)
            text = out.text.strip()
        self.on_event("transcription", {"text": text})
        if not text:
            return None
        self.history.append({"role": "user", "content": text})
        reply = self.llm.generate(text, self.history)
        self.history.append({"role": "assistant", "content": reply})
        self.on_event("response", {"text": reply})
        self._speak(reply)
        return reply

    def _speak(self, text: str) -> None:
        if self.tts is None:
            return
        self._speaking.set()
        kwargs = {"voice": self.tts_voice} if self.tts_voice else {}
        for result in self.scheduler.run(
                lambda: list(self.tts.generate(text, **kwargs))):
            if not self._speaking.is_set():
                break  # barged in
            self.audio_output.queue_audio(np.asarray(result.audio))
        self._speaking.clear()

    # -- output path ---------------------------------------------------------

    def fetch_speech(self, timeout: float = 0.0) -> Optional[np.ndarray]:
        """Pull the next synthesized speech chunk (headless speaker); the
        chunk is stamped into the output history for echo rejection."""
        return self.audio_output.fetch_chunk(timeout=timeout)

    def run_microphone(self):  # pragma: no cover - needs audio hardware
        """Live mic loop via sounddevice (reference main :1380)."""
        import sounddevice as sd

        def callback(indata, frames, time_info, status):
            self.feed_audio(indata[:, 0])

        with sd.InputStream(samplerate=SAMPLE_RATE, channels=1,
                            blocksize=VAD_FRAME, callback=callback):
            while True:
                time.sleep(0.1)

    def shutdown(self):
        self.scheduler.shutdown()


def main(argv=None):  # pragma: no cover - interactive entry point
    import argparse

    parser = argparse.ArgumentParser(description="Local voice assistant")
    parser.add_argument("--stt-model", default=None)
    parser.add_argument("--tts-model", default=None)
    parser.add_argument("--vad-model", default=None)
    parser.add_argument("--smart-turn-model", default=None)
    parser.add_argument("--voice", default=None)
    parser.add_argument("--device", default="cuda",
                        help="the models' device (default: the card)")
    args = parser.parse_args(argv)
    from ..utils import load_model

    def load(path):
        return load_model(path, device=args.device) if path else None

    pipeline = VoicePipeline(
        vad_model=load(args.vad_model),
        stt_model=load(args.stt_model),
        tts_model=load(args.tts_model),
        smart_turn_model=load(args.smart_turn_model),
        tts_voice=args.voice,
        on_event=lambda kind, data: print(f"[{kind}] {data}"),
    )
    pipeline.run_microphone()


if __name__ == "__main__":
    main()
