"""Server-side turn detection for the `/v1/realtime` WebSocket endpoint.

The port's own copy of mlx_audio_tpu/realtime_vad.py (the port imports
nothing of the JAX package): `ServerVadConfig`, `parse_turn_detection`,
`TurnDetector`, a pure state machine over per-frame probabilities, and
`StreamingVad`, which frames a 16 kHz stream into 512-sample windows for
the port's Silero (`vad/models/silero_vad`). OpenAI's `server_vad`
semantics: threshold / prefix_padding_ms / silence_duration_ms.

One change: a frame's probability may be a tensor on the card (Silero's
`feed` reads nothing to the host); `StreamingVad` reads it as a float,
where the JAX package converts it through numpy.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import List, Optional

import numpy as np

VAD_SAMPLE_RATE: int = 16000
VAD_FRAME_SIZE: int = 512
VAD_FRAME_MS: float = 1000.0 * VAD_FRAME_SIZE / VAD_SAMPLE_RATE


class TurnDetectionError(ValueError):
    """Unsupported `turn_detection` request from a client."""


@dataclass(frozen=True)
class ServerVadConfig:
    threshold: float = 0.5
    prefix_padding_ms: int = 300
    silence_duration_ms: int = 500

    def to_dict(self) -> dict:
        return {
            "type": "server_vad",
            "threshold": self.threshold,
            "prefix_padding_ms": self.prefix_padding_ms,
            "silence_duration_ms": self.silence_duration_ms,
        }


def parse_turn_detection(turn_detection: Optional[dict]) -> Optional[ServerVadConfig]:
    """OpenAI `turn_detection` object -> config; None = manual commit mode."""
    if not turn_detection:
        return None
    td_type = turn_detection.get("type")
    if td_type == "server_vad":
        d = ServerVadConfig()
        return ServerVadConfig(
            threshold=float(turn_detection.get("threshold", d.threshold)),
            prefix_padding_ms=int(
                turn_detection.get("prefix_padding_ms", d.prefix_padding_ms)),
            silence_duration_ms=int(
                turn_detection.get("silence_duration_ms",
                                   d.silence_duration_ms)),
        )
    if td_type == "semantic_vad":
        raise TurnDetectionError(
            "semantic_vad is not supported by this server yet; use server_vad")
    raise TurnDetectionError(f"unknown turn_detection type: {td_type!r}")


class TurnEventKind(str, Enum):
    SPEECH_STARTED = "speech_started"
    SPEECH_STOPPED = "speech_stopped"


@dataclass(frozen=True)
class TurnEvent:
    kind: TurnEventKind
    audio_ms: int


class TurnDetector:
    """Endpointing over per-frame speech probabilities.

    SPEECH_STARTED fires on the first frame over threshold (its reported
    offset is pulled back by prefix_padding_ms); SPEECH_STOPPED fires after
    silence_duration_ms of sub-threshold frames. The clock is monotonic over
    the session.
    """

    def __init__(self, config: ServerVadConfig):
        self._config = config
        self._elapsed_ms = 0.0
        self._in_speech = False
        self._silence_ms = 0.0

    def push(self, probability: float, frame_ms: float) -> List[TurnEvent]:
        self._elapsed_ms += frame_ms
        events: List[TurnEvent] = []
        is_speech = probability >= self._config.threshold
        if not self._in_speech:
            if is_speech:
                self._in_speech = True
                self._silence_ms = 0.0
                start = (self._elapsed_ms - frame_ms
                         - self._config.prefix_padding_ms)
                events.append(TurnEvent(TurnEventKind.SPEECH_STARTED,
                                        max(0, int(start))))
        elif is_speech:
            self._silence_ms = 0.0
        else:
            self._silence_ms += frame_ms
            if self._silence_ms >= self._config.silence_duration_ms:
                self._in_speech = False
                self._silence_ms = 0.0
                events.append(TurnEvent(TurnEventKind.SPEECH_STOPPED,
                                        int(self._elapsed_ms)))
        return events

    @property
    def in_speech(self) -> bool:
        return self._in_speech

    def reset_turn(self) -> None:
        self._in_speech = False
        self._silence_ms = 0.0


class StreamingVad:
    """Frame a 16 kHz stream into 512-sample VAD windows and endpoint it.

    `vad_model` follows the Silero streaming protocol:
    initial_state(sample_rate=) / feed(chunk, state, sample_rate=) ->
    (probability, state).
    """

    def __init__(self, vad_model, config: ServerVadConfig):
        self._vad = vad_model
        self._config = config
        self._state = vad_model.initial_state(sample_rate=VAD_SAMPLE_RATE)
        self._detector = TurnDetector(config)
        self._buffer = np.zeros(0, dtype=np.float32)

    def process(self, samples: np.ndarray) -> List[TurnEvent]:
        if samples.size:
            self._buffer = np.concatenate(
                [self._buffer, samples.astype(np.float32)])
        events: List[TurnEvent] = []
        while self._buffer.shape[0] >= VAD_FRAME_SIZE:
            frame = self._buffer[:VAD_FRAME_SIZE]
            self._buffer = self._buffer[VAD_FRAME_SIZE:]
            probability, self._state = self._vad.feed(
                frame, self._state, sample_rate=VAD_SAMPLE_RATE)
            prob = float(probability.reshape(-1)[0])
            events.extend(self._detector.push(prob, VAD_FRAME_MS))
        return events

    @property
    def in_speech(self) -> bool:
        return self._detector.in_speech

    def reset_turn(self) -> None:
        self._detector.reset_turn()
