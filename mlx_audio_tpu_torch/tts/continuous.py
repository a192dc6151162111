"""Continuous-batching protocol types for TTS serving.

The port's own copy of mlx_audio_tpu/tts/continuous.py (`TTSBatchOptions`,
`TTSBatchItem`, `TTSBatchEvent`, the `TTSBatchSession` protocol), standard
library only. The broker (server_inference.py) drives sessions through this
protocol; a session is a fixed-slot batched decode (one k-frame chunk over a
stacked KV cache with per-row validity masks): rows are admitted and retired
by writing cache slices, never by reshaping.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional, Protocol


@dataclass
class TTSBatchOptions:
    max_batch_size: int = 8
    max_tokens: int = 1200
    temperature: float = 0.9
    top_k: int = 50
    top_p: float = 1.0
    repetition_penalty: float = 1.05
    streaming_interval: float = 2.0
    voice: Optional[str] = None
    language: str = "auto"
    # session KV-timeline capacity (None = implementation default). Decode
    # attention streams the whole fixed buffer every frame, so right-sizing
    # this to the deployment's horizon is a first-order throughput knob.
    max_cache_len: Optional[int] = None
    # prompt prefills admitted per step() call: a burst of submissions is
    # staggered so already-admitted rows keep decoding (and streaming their
    # first audio) between admissions instead of waiting behind every
    # prefill (a burst with no live stream is admitted whole)
    admits_per_step: int = 2


@dataclass
class TTSBatchItem:
    request_id: str
    text: str
    options: TTSBatchOptions = field(default_factory=TTSBatchOptions)
    voice: Optional[str] = None
    seed: int = 0


@dataclass
class TTSBatchEvent:
    """One event emitted by a session step: audio chunk / done / error."""

    request_id: str
    kind: str  # "chunk" | "done" | "error"
    audio: Any = None
    sample_rate: int = 24000
    token_count: int = 0
    error: Optional[BaseException] = None


class TTSBatchSession(Protocol):
    @property
    def idle(self) -> bool: ...

    @property
    def available_slots(self) -> int: ...

    def add(self, item: TTSBatchItem) -> None: ...

    def cancel(self, request_id: str) -> None: ...

    def step(self) -> list: ...
