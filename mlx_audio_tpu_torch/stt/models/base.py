"""STT result schema and the streaming-session event.

The port's own copy of mlx_audio_tpu/stt/models/base.py, kept equal to it:
the port imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class StreamingEvent:
    """One step() result from a live STT session.

    The shared protocol between streaming sessions (whisper,
    voxtral_realtime) and their consumers (`/v1/realtime` in server.py
    drains `kind == "delta"` text and takes `kind == "final"` as the turn's
    transcript; reference server.py:1549-1936 consumes the same shape).
    """

    kind: str  # "delta" | "final"
    text: str


@dataclass
class STTOutput:
    text: str
    segments: Optional[List[dict]] = None
    language: Optional[str] = None
    prompt_tokens: int = 0
    generation_tokens: int = 0
    total_tokens: int = 0
    prompt_tps: float = 0.0
    generation_tps: float = 0.0
    total_time: float = 0.0
