"""Streaming transcription session for Whisper-family models.

Counterpart of mlx_audio_tpu/stt/models/whisper/streaming.py: the session
surface that `WS /v1/realtime` consumes (feed / step / close / done /
input_sample_rate, `StreamingEvent` deltas and a final event).

Strategy: local-agreement incremental decoding. Audio accumulates; each
step re-decodes the active window (its log-mel on the model's device) and
commits the longest common prefix of the last two hypotheses. Confirmed
text is emitted as deltas; when the window fills, the audio is trimmed to
it and the committed tokens carry continuity through the decode prompt.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..base import StreamingEvent  # shared session protocol
from .audio import SAMPLE_RATE, log_mel_spectrogram, pad_or_trim


class WhisperStreamingSession:
    """Incremental transcription with local-agreement commitment."""

    def __init__(self, model, language: str = "en",
                 min_step_seconds: float = 1.0):
        self.model = model
        self.language = language
        self.min_step_samples = int(min_step_seconds * SAMPLE_RATE)
        self._audio = np.zeros(0, np.float32)
        self._since_decode = 0
        self._prev_hyp: List[int] = []
        self._committed: List[int] = []
        self._emitted_text = ""
        self._closed = False
        self._done = False
        self.tokenizer = model.get_tokenizer(language=language)

    @property
    def input_sample_rate(self) -> int:
        return SAMPLE_RATE

    # -- protocol ------------------------------------------------------------

    def feed(self, samples: np.ndarray) -> None:
        samples = np.asarray(samples, np.float32).reshape(-1)
        self._audio = np.concatenate([self._audio, samples])
        self._since_decode += len(samples)

    def step(self) -> List[StreamingEvent]:
        """Decode if enough new audio arrived; return text deltas."""
        if self._done:
            return []
        if not self._closed and self._since_decode < self.min_step_samples:
            return []
        if len(self._audio) < SAMPLE_RATE // 4 and not self._committed:
            if self._closed:
                self._done = True
            return []
        self._since_decode = 0
        hyp = self._decode_current()
        events: List[StreamingEvent] = []
        if self._closed:
            # everything is final
            final = self._committed + hyp
            text = self.tokenizer.decode(
                [t for t in final if t < self.tokenizer.eot]).strip()
            delta = text[len(self._emitted_text):]
            if delta:
                events.append(StreamingEvent("delta", delta))
            events.append(StreamingEvent("final", text))
            self._emitted_text = text
            self._done = True
            return events
        # local agreement: commit the common prefix of consecutive hypotheses
        agree = 0
        for a, b in zip(self._prev_hyp, hyp):
            if a != b:
                break
            agree += 1
        self._prev_hyp = hyp
        if agree:
            newly = hyp[:agree]
            self._committed += newly
            text = self.tokenizer.decode(
                [t for t in self._committed if t < self.tokenizer.eot])
            delta = text[len(self._emitted_text):]
            self._emitted_text = text
            self._prev_hyp = hyp[agree:]
            self._trim_window(agree)
            if delta.strip():
                events.append(StreamingEvent("delta", delta))
        return events

    def close(self) -> None:
        self._closed = True

    @property
    def done(self) -> bool:
        return self._done

    @property
    def text(self) -> str:
        return self._emitted_text

    # -- internals -----------------------------------------------------------

    def _decode_current(self) -> List[int]:
        from .decoding import DecodingOptions, DecodingTask

        window = self._audio[-self.model.window_samples:]
        mel = log_mel_spectrogram(window, n_mels=self.model.dims.n_mels,
                                  device=self.model.device)
        mel = pad_or_trim(mel, self.model.window_frames)[None]
        task = DecodingTask(self.model, DecodingOptions(
            language=self.language, without_timestamps=True,
            sample_len=min(96, self.model.dims.n_text_ctx // 2)))
        result = task.run(mel, list(self._committed[-32:]), temperature=0.0)
        return [int(t) for t in result.tokens]

    def _trim_window(self, committed_tokens: int) -> None:
        """Drop audio older than the window once the buffer overflows; the
        committed text anchors continuity through the decode prompt."""
        max_keep = self.model.window_samples
        if len(self._audio) > max_keep:
            self._audio = self._audio[-max_keep:]


def create_streaming_session(model, language: str = "en", **kwargs):
    return WhisperStreamingSession(model, language=language, **kwargs)
